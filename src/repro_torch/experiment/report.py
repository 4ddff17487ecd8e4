"""Sweep reports (``repro/experiment/report.py``): group-by over the
manifest, mean ± std across runs, in the reference's schema and column
order, so a manifest written by either package reports identically::

    {"format": 1, "sweep": "<name>", "group_by": ["method", ...],
     "total_runs": N, "done": k, "complete": bool,
     "groups": [{"key": {"method": "fedphd"}, "n": 3, "runs": [ids...],
                 "metrics": {"loss": {"mean":.., "std":.., "min":..,
                                      "max":.., "n": 3}, ...}}]}

Per-run scalars (``run_scalars``): final-round ``loss``, total
``comm_gb`` over the run, final ``params_m``, executor ``wall_s``, and
every numeric key of the last recorded eval as ``eval.<key>`` — so an
``eval_fn`` returning ``{"fid": ...}`` aggregates as ``eval.fid``.
Groups are keyed by the *effective* value of each group-by axis
(override if the axis varied, base-spec value otherwise); mean±std runs
over whatever remains inside a group — canonically the seed axis.

``report_markdown`` renders the same data as a GitHub-flavored table;
``write_report`` emits both ``report.json`` and ``report.md`` next to
the sweep manifest.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.experiment.sweep import spec_get

REPORT_FORMAT = 1

# canonical column order: the shared RoundRecord scalars first, then
# wall-clock, then eval.* alphabetically
_METRIC_ORDER = ("loss", "comm_gb", "params_m", "wall_s")


def run_scalars(entry: Mapping[str, Any]) -> Dict[str, float]:
    """The aggregatable scalars of one manifest run entry."""
    hist = entry.get("history") or []
    if not hist:
        return {}
    last = hist[-1]
    out = {
        "loss": float(last["loss"]),
        "comm_gb": float(sum(r["comm_gb"] for r in hist)),
        "params_m": float(last["params_m"]),
    }
    if entry.get("wall_s"):
        out["wall_s"] = float(entry["wall_s"])
    # executor-side trace spans (sweep.json entry["trace"]): surface the
    # scheduling story — attempts, time queued, time lost to retries
    trace = entry.get("trace") or []
    if entry.get("attempts"):
        out["attempts"] = float(entry["attempts"])
    queue_s = sum(s["dur_s"] for s in trace
                  if s.get("name") == "sweep/queue")
    # retry cost = scheduled backoff windows + wall time of every
    # attempt that did NOT complete the run
    retry_s = sum(
        s["dur_s"] for s in trace
        if s.get("name") == "sweep/backoff"
        or (s.get("name") == "sweep/attempt"
            and s.get("attrs", {}).get("outcome") != "done"))
    if trace:
        out["queue_s"] = float(queue_s)
        out["retry_s"] = float(retry_s)
    for r in reversed(hist):               # last recorded eval wins
        ev = r.get("eval")
        if ev is None:
            continue
        if isinstance(ev, Mapping):
            for k, v in ev.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out[f"eval.{k}"] = float(v)
        elif isinstance(ev, (int, float)) and not isinstance(ev, bool):
            out["eval"] = float(ev)
        break
    return out


def _mean_std(vals: Sequence[float]) -> Dict[str, float]:
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / n       # population std:
    return {"mean": mean, "std": math.sqrt(var),       # std=0 at n=1
            "min": min(vals), "max": max(vals), "n": n}


def _group_key(entry: Mapping[str, Any],
               group_by: Sequence[str]) -> Tuple:
    overrides = entry.get("overrides") or {}
    key = []
    for axis in group_by:
        if axis in overrides:
            key.append(overrides[axis])
        else:
            key.append(spec_get(entry["spec"], axis))
    return tuple(key)


def build_report(man: Mapping[str, Any],
                 group_by: Optional[Sequence[str]] = None) -> dict:
    """Aggregate a sweep manifest.  ``group_by`` defaults to the sweep's
    declared grouping (its non-seed axes); only ``done`` runs enter the
    aggregation — ``complete``/``done``/``total_runs`` expose how much
    of the grid the numbers cover."""
    from repro_torch.experiment.sweep import SweepSpec
    sweep = SweepSpec.from_dict(man["sweep"])
    group_by = tuple(group_by) if group_by else sweep.default_group_by()

    groups: Dict[Tuple, Dict[str, Any]] = {}
    done = failed = 0
    for rid, entry in man["runs"].items():
        # failed (quarantined) runs surface in the report instead of
        # silently shrinking a group's n; pending/running stay invisible
        if entry["status"] not in ("done", "failed"):
            continue
        key = _group_key(entry, group_by)
        g = groups.setdefault(key, {"runs": [], "scalars": [],
                                    "failed": []})
        if entry["status"] == "done":
            done += 1
            g["runs"].append(rid)
            g["scalars"].append(run_scalars(entry))
        else:
            failed += 1
            g["failed"].append(rid)

    out_groups = []
    for key, g in groups.items():          # insertion = manifest order
        names = sorted({m for s in g["scalars"] for m in s})
        metrics = {}
        for m in names:
            vals = [s[m] for s in g["scalars"] if m in s]
            if vals:
                metrics[m] = _mean_std(vals)
        out_groups.append({
            "key": dict(zip(group_by, key)),
            "n": len(g["runs"]),
            "runs": g["runs"],
            "failed": len(g["failed"]),
            "failed_runs": g["failed"],
            "metrics": metrics,
        })
    total = len(man["runs"])
    return {
        "format": REPORT_FORMAT,
        "sweep": sweep.name,
        "group_by": list(group_by),
        "total_runs": total,
        "done": done,
        "failed": failed,
        "complete": done == total,
        "groups": out_groups,
    }


def _metric_columns(report: Mapping[str, Any]) -> List[str]:
    names = sorted({m for g in report["groups"] for m in g["metrics"]})
    head = [m for m in _METRIC_ORDER if m in names]
    return head + [m for m in names if m not in _METRIC_ORDER]


def _fmt(x: Any) -> str:
    if isinstance(x, float):
        return f"{x:.4g}"
    return str(x)


def report_markdown(report: Mapping[str, Any]) -> str:
    """The report as one GitHub-flavored markdown table (mean ± std).

    A ``failed`` column appears only when the sweep has quarantined
    runs, so clean sweeps render exactly as before."""
    group_by = report["group_by"]
    metrics = _metric_columns(report)
    n_failed = report.get("failed", 0)
    lines = [f"# sweep `{report['sweep']}` — {report['done']}/"
             f"{report['total_runs']} runs"
             + (f", {n_failed} FAILED" if n_failed else "")
             + ("" if report["complete"] else " (INCOMPLETE)"),
             ""]
    header = [*group_by, "n", *(["failed"] if n_failed else []), *metrics]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "---|" * len(header))
    for g in report["groups"]:
        cells = [_fmt(g["key"][a]) for a in group_by] + [str(g["n"])]
        if n_failed:
            cells.append(str(g.get("failed", 0)))
        for m in metrics:
            st = g["metrics"].get(m)
            cells.append(f"{st['mean']:.4g} ± {st['std']:.2g}"
                         if st else "—")
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def write_report(man: Mapping[str, Any], out: str,
                 group_by: Optional[Sequence[str]] = None) -> dict:
    """Build the report and persist ``report.json`` + ``report.md``
    next to the sweep manifest; returns the report dict."""
    report = build_report(man, group_by)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "report.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(os.path.join(out, "report.md"), "w") as f:
        f.write(report_markdown(report))
    return report
