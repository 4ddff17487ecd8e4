"""Observability layer (``repro/obs``): structured tracing for rounds
and serving.

Every instrumented call site holds a tracer that is either a real
:class:`~repro_torch.obs.trace.Tracer` (JSON-lines span, counter and
event lines) or the shared :data:`~repro_torch.obs.trace.NULL_TRACER`,
whose methods are no-ops and whose ``span()`` returns one reusable no-op
context manager.  Tracing is host wall clock only: it never draws a
random number, reads a device value or synchronizes the device, so a
traced run gives the same params and histories, bit for bit, as an
untraced one (``tests/test_torch_obs.py``).

Enable it per run with ``ExperimentSpec(obs=ObsSpec(enabled=True))``,
the CLIs' ``--trace`` flag, or ``$FEDPHD_OBS=1`` (explicit > env > off,
:mod:`repro_torch.experiment.resolve`).  The schema is
:mod:`repro_torch.obs.trace`'s, the reference's key for key.
"""
from repro_torch.obs.compile_tracker import CompileTracker, cache_size
from repro_torch.obs.metrics import read_trace, summarize_trace
from repro_torch.obs.spec import ObsSpec
from repro_torch.obs.trace import (NULL_TRACER, SCHEMA_VERSION, NullTracer,
                                   Tracer, make_tracer)

__all__ = ["CompileTracker", "cache_size", "read_trace", "summarize_trace",
           "ObsSpec", "NULL_TRACER", "SCHEMA_VERSION", "NullTracer",
           "Tracer", "make_tracer"]
