"""The CLI surface shared with ``repro.experiment.cli``:
``python -m repro_torch.experiment.runner`` and ``python -m
repro_torch.serve`` speak the same ``--trace`` and ``--metrics`` flags
and write one JSON metrics schema,

  {"schema": 1, "kind": "experiment" | "serve", <flat metric keys>}

``--trace`` is the CLI face of the obs layer: bare ``--trace`` enables
tracing at the entry point's default path, ``--trace path.jsonl`` pins
the path, and leaving it out defers to ``$FEDPHD_OBS``.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.trace import make_tracer

METRICS_SCHEMA = 1


def add_obs_flags(ap: argparse.ArgumentParser) -> None:
    """``--trace [PATH]``: enable obs tracing (bare flag = the entry
    point's default trace.jsonl location)."""
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="enable obs tracing; optional trace.jsonl path "
                         "(bare --trace writes next to the run's output; "
                         "omitted entirely defers to $FEDPHD_OBS)")


def cli_obs_spec(trace_arg: Optional[str]) -> ObsSpec:
    """``--trace`` value -> ObsSpec: the flag given = explicitly enabled
    (with its path, if any); absent = None, i.e. ``$FEDPHD_OBS``."""
    if trace_arg is None:
        return ObsSpec()
    return ObsSpec(enabled=True, trace=trace_arg)


def make_cli_tracer(trace_arg: Optional[str],
                    default_path: Optional[str] = None):
    """The entry point's tracer straight from its ``--trace`` value (for
    entry points without an ExperimentSpec: serve)."""
    return make_tracer(cli_obs_spec(trace_arg), default_path=default_path)


def write_metrics(path: str, kind: str, metrics: dict) -> None:
    """Flat metric keys under a shared ``{schema, kind}`` envelope."""
    payload = {"schema": METRICS_SCHEMA, "kind": kind, **metrics}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
