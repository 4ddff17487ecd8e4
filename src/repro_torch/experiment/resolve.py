"""Precision resolution: explicit > ``$FEDPHD_PRECISION`` > ``"fp32"``,
the reference's contract (``repro/experiment/resolve.py``)."""
from __future__ import annotations

import os
from typing import Optional

PRECISIONS = ("fp32", "bf16")
ENV = "FEDPHD_PRECISION"


def resolve_precision(precision: Optional[str] = None) -> str:
    if precision:
        source, value = "explicit precision", precision
    else:
        source, value = f"${ENV}", os.environ.get(ENV, "") or "fp32"
    if value not in PRECISIONS:
        raise ValueError(f"{source}={value!r} is not one of {PRECISIONS}")
    return value
