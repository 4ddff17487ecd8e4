"""The metrics envelope shared with ``repro.experiment.cli``."""
from __future__ import annotations

import json

METRICS_SCHEMA = 1


def write_metrics(path: str, kind: str, metrics: dict) -> None:
    """Flat metric keys under a shared ``{schema, kind}`` envelope."""
    payload = {"schema": METRICS_SCHEMA, "kind": kind, **metrics}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
