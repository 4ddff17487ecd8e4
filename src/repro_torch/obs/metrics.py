"""Trace-derived metrics: phase totals, pipeline overlap, recompiles
(``repro/obs/metrics.py``, copied).

Post-hoc analysis of a ``trace.jsonl`` — nothing here runs on the hot
path.  The headline number is the **overlap ratio**: the trainers' "run()"
double-buffers rounds (``_start_round(r+1)`` executes while round r's
device compute is in flight, before ``_finish_round(r)`` syncs its
losses), and the phase spans make that overlap directly measurable:

    window(r)  = loss_sync(r).t0 - dispatch(r).t1
                 (the in-flight gap of round r)
    hidden(r)  = host-side span time of round r+1 (host_prep, h2d,
                 dispatch) clipped to window(r)
    overlap    = sum_r hidden(r) / sum_r window(r)

~1.0 means the next round's host prep + H2D staging is fully hidden
behind device compute (the ROADMAP's "as fast as the hardware allows"
north star); ~0.0 means stepped, serialized rounds.  Spans are only
compared within one tracer session (between ``meta`` lines) because
``perf_counter`` readings are not comparable across processes.
"""
from __future__ import annotations

import json
from typing import List, Optional, Union

# next-round host-side phases that can hide behind in-flight device work
HOST_PHASES = ("round/host_prep", "round/h2d", "round/dispatch")


def read_trace(path: str) -> List[dict]:
    """Parse a trace.jsonl into a list of event dicts (skips blanks)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _sessions(events: List[dict]) -> List[List[dict]]:
    """Split a trace at its meta lines (one session per tracer open)."""
    sessions, cur = [], []
    for ev in events:
        if ev.get("ev") == "meta":
            if cur:
                sessions.append(cur)
            cur = []
        else:
            cur.append(ev)
    if cur:
        sessions.append(cur)
    return sessions


def _overlap(session: List[dict]):
    """(hidden_s, window_s) summed over consecutive round pairs."""
    disp_end, sync_start, host = {}, {}, {}
    for ev in session:
        if ev.get("ev") != "span":
            continue
        r = ev.get("attrs", {}).get("round")
        if r is None:
            continue
        if ev["name"] == "round/dispatch":
            disp_end[r] = max(disp_end.get(r, ev["t1"]), ev["t1"])
        elif ev["name"] == "round/loss_sync":
            sync_start[r] = min(sync_start.get(r, ev["t0"]), ev["t0"])
        if ev["name"] in HOST_PHASES:
            host.setdefault(r, []).append((ev["t0"], ev["t1"]))
    hidden = window = 0.0
    for r, t_d in disp_end.items():
        t_s = sync_start.get(r)
        if t_s is None or t_s <= t_d:
            continue
        window += t_s - t_d
        for (a, b) in host.get(r + 1, []):
            hidden += max(0.0, min(b, t_s) - max(a, t_d))
    return hidden, window


def summarize_trace(trace: Union[str, List[dict]]) -> dict:
    """Aggregate a trace into per-phase totals, the measured overlap
    ratio, and compile/recompile counts.

    Returns ``{"sessions", "rounds", "phases": {name: {"n", "total_s",
    "mean_s", "max_s"}}, "overlap_ratio" (None when no in-flight window
    was observed), "overlap_hidden_s", "overlap_window_s", "compiles",
    "recompiles"}``.
    """
    events = read_trace(trace) if isinstance(trace, str) else list(trace)
    phases, rounds = {}, set()
    compiles = recompiles = 0
    for ev in events:
        kind = ev.get("ev")
        if kind == "span":
            st = phases.setdefault(ev["name"],
                                   {"n": 0, "total_s": 0.0, "max_s": 0.0})
            st["n"] += 1
            st["total_s"] += ev["dur_s"]
            st["max_s"] = max(st["max_s"], ev["dur_s"])
            r = ev.get("attrs", {}).get("round")
            if r is not None:
                rounds.add(r)
        elif kind == "counter" and ev["name"].startswith("compile/"):
            compiles += ev.get("value", 0)
            recompiles += ev.get("attrs", {}).get("unexpected", 0)
    for st in phases.values():
        st["mean_s"] = st["total_s"] / st["n"]
    hidden = window = 0.0
    sessions = _sessions(events)
    for session in sessions:
        h, w = _overlap(session)
        hidden += h
        window += w
    return {
        "sessions": len(sessions),
        "rounds": len(rounds),
        "phases": phases,
        "overlap_ratio": (hidden / window) if window > 0 else None,
        "overlap_hidden_s": hidden,
        "overlap_window_s": window,
        "compiles": int(compiles),
        "recompiles": int(recompiles),
    }
