"""The trace emitters: Tracer (JSON-lines) and the no-op NullTracer
(``repro/obs/trace.py``, copied: the port imports nothing of the JAX
package).

Schema (stable; tests/test_obs.py pins the golden keys) — one JSON
object per line of ``trace.jsonl``:

  meta     {"ev":"meta", "schema":1, "wall_time":<epoch s>, "attrs":{}}
           one per tracer open; a resumed run appends a new meta line,
           so sessions are delimited in-band
  span     {"ev":"span", "name":<str>, "t0":<s>, "t1":<s>,
            "dur_s":<s>, "attrs":{...}}
           t0/t1 are time.perf_counter() readings — monotonic and
           mutually comparable within one session (between two meta
           lines), which is all the overlap math needs
  event    {"ev":"event", "name":<str>, "t":<s>, "attrs":{...}}
  counter  {"ev":"counter", "name":<str>, "t":<s>, "value":<num>,
            "attrs":{...}}

Span names in use: ``round/host_prep``, ``round/h2d``,
``round/dispatch``, ``round/loss_sync``, ``round/edge_agg``,
``round/cloud_agg``, ``round/prune`` (trainers; ``attrs.round`` keys
the round), ``serve/tick`` (DiffusionServer).  Counter names:
``compile/<cache>`` (host-cache growth,
:mod:`repro_torch.obs.compile_tracker`; ``attrs.unexpected`` > 0 flags
growth the tracker did not expect).  Event names:
``fault/draw`` (availability summary), ``serve/fault``.

Everything here is host-side bookkeeping: no torch import, so no
device sync, no device read and no random draw.  The NULL_TRACER
singleton makes the disabled path a handful of attribute lookups and
a no-op context manager — cheap enough to leave the instrumentation
permanently in the hot loops.
"""
from __future__ import annotations

import json
import time
from typing import Optional

SCHEMA_VERSION = 1

# golden key sets (tests/test_obs.py asserts these exact sets per ev)
SPAN_KEYS = ("ev", "name", "t0", "t1", "dur_s", "attrs")
EVENT_KEYS = ("ev", "name", "t", "attrs")
COUNTER_KEYS = ("ev", "name", "t", "value", "attrs")
META_KEYS = ("ev", "schema", "wall_time", "attrs")


class _NullSpan:
    """Reusable no-op context manager (one shared instance)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a no-op.

    Shared singleton (:data:`NULL_TRACER`); trainers hold it when obs
    is off so call sites never branch on "is tracing on?".
    """
    enabled = False
    compile_tracking = False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def record_span(self, name, t0, t1, **attrs):
        pass

    def event(self, name, **attrs):
        pass

    def counter(self, name, value, **attrs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._emit({"ev": "span", "name": self._name,
                            "t0": self._t0, "t1": t1,
                            "dur_s": t1 - self._t0, "attrs": self._attrs})
        return False


class Tracer:
    """JSON-lines trace writer (append mode: resumes extend the file)."""
    enabled = True

    def __init__(self, path: str, *, flush_every: int = 1,
                 compile_tracking: bool = True):
        self.path = str(path)
        self.compile_tracking = compile_tracking
        self._flush_every = max(1, int(flush_every))
        self._buf = []
        self._f = open(self.path, "a")
        self._emit({"ev": "meta", "schema": SCHEMA_VERSION,
                    "wall_time": time.time(), "attrs": {}})

    # -- emission ----------------------------------------------------------

    def span(self, name: str, **attrs) -> _Span:
        """Context manager timing a phase; attrs land on the span line."""
        return _Span(self, name, attrs)

    def record_span(self, name: str, t0: float, t1: float, **attrs):
        """A span with externally measured perf_counter endpoints."""
        self._emit({"ev": "span", "name": name, "t0": t0, "t1": t1,
                    "dur_s": t1 - t0, "attrs": attrs})

    def event(self, name: str, **attrs):
        self._emit({"ev": "event", "name": name,
                    "t": time.perf_counter(), "attrs": attrs})

    def counter(self, name: str, value, **attrs):
        self._emit({"ev": "counter", "name": name,
                    "t": time.perf_counter(), "value": value,
                    "attrs": attrs})

    # -- plumbing ----------------------------------------------------------

    def _emit(self, obj: dict):
        if self._f is None:
            return
        self._buf.append(json.dumps(obj, sort_keys=True))
        if len(self._buf) >= self._flush_every:
            self.flush()

    def flush(self):
        if self._f is None or not self._buf:
            return
        self._f.write("\n".join(self._buf) + "\n")
        self._f.flush()
        self._buf.clear()

    def close(self):
        if self._f is None:
            return
        self.flush()
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_tracer(obs=None, default_path: Optional[str] = None):
    """Build the run's tracer from an ObsSpec (or None).

    Returns :data:`NULL_TRACER` unless the spec resolves enabled
    (explicit ``enabled`` > ``$FEDPHD_OBS`` > off).  The trace path is
    ``obs.trace`` if set, else ``default_path`` (callers pass a file
    next to the checkpoint), else ``trace.jsonl`` in the CWD.
    """
    if obs is None or not obs.resolved_enabled:
        return NULL_TRACER
    path = obs.trace or default_path or "trace.jsonl"
    return Tracer(path, flush_every=obs.flush_every,
                  compile_tracking=obs.compile_tracking)
