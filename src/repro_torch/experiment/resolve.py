"""Knob resolution, the reference's contract (``repro/experiment/
resolve.py``): an explicit argument wins, then the ``$FEDPHD_*``
environment variable, then the default."""
from __future__ import annotations

import os
from typing import Optional, Tuple

PRECISIONS = ("fp32", "bf16")
ENV = "FEDPHD_PRECISION"
ENGINES = ("auto", "vectorized", "sequential")
ENGINE_ENV = "FEDPHD_ENGINE"


def _resolve(explicit: Optional[str], env: str, default: str, choices,
             what: str) -> str:
    if explicit:
        source, value = f"explicit {what}", explicit
    else:
        source, value = f"${env}", os.environ.get(env, "") or default
    if value not in choices:
        raise ValueError(f"{source}={value!r} is not one of {choices}")
    return value


def resolve_precision(precision: Optional[str] = None) -> str:
    """Explicit > ``$FEDPHD_PRECISION`` > ``"fp32"``."""
    return _resolve(precision, ENV, "fp32", PRECISIONS, "precision")


def resolve_engine(engine: Optional[str] = None) -> Tuple[str, bool]:
    """``(engine, strict)``: explicit > ``$FEDPHD_ENGINE`` > ``"auto"``.
    Only an explicit choice is strict: a strict "vectorized" raises on
    clients of ragged batch shapes, where an env-selected one falls back
    to the sequential engine with a warning
    (:func:`repro_torch.fl.engine.route_engine`)."""
    return (_resolve(engine, ENGINE_ENV, "auto", ENGINES, "engine"),
            engine is not None)
