"""Host-cache growth tracking: the counterpart of the reference's jit-cache
tracker (``repro/obs/compile_tracker.py``), as trace counters.

The port has no jit.  What it builds at run time, and keeps, is:

  * the matmul's launch plan, one entry per GEMM shape
    (``kernels/block_masked_matmul/ops.py:plan``, an ``lru_cache``);
  * the group-L2 member table, one entry per launch signature
    (``kernels/group_l2_norms/ops.py:table``, an ``lru_cache``);
  * the kernel library, built by nvcc once per source hash
    (``kernels/build.py:build``, which counts its builds).

:func:`cache_size` reads an ``lru_cache``'s misses (not ``currsize``:
eviction keeps ``currsize`` flat while the cache rebuilds entries) and
the build counter, and is None for anything else.  The contract differs
from the reference's in one point: each ``watch()`` grants one expected
*check with growth*, whatever its size, where a jit grants one entry.
The first round fills one plan entry per GEMM shape where a jit fills
one cache entry, so the grant cannot be counted in entries.  Growth in
any later check without a re-watch is *unexpected*: a shape that was
not there before, the regression the ROADMAP's "zero steady-state
recompiles" line guards.  The trainers re-watch at the prune (from
``_rebuild_steps``), whose compacted model brings new shapes.
"""
from __future__ import annotations

from typing import Dict, Optional


def host_caches() -> Dict[str, object]:
    """The port's run-time caches, by the name their counters carry."""
    from repro_torch.kernels import build
    from repro_torch.kernels.block_masked_matmul import ops as bmm
    from repro_torch.kernels.group_l2_norms import ops as gl2
    return {"matmul_plan": bmm.plan, "group_l2_table": gl2.table,
            "nvcc_build": build.build}


def cache_size(fn) -> Optional[int]:
    """Entries ``fn`` has built so far: an ``lru_cache``'s misses, the
    kernel library's nvcc builds; None for anything else."""
    info = getattr(fn, "cache_info", None)
    if info is not None:
        return int(info().misses)
    from repro_torch.kernels import build
    if fn is build.build:
        return build.builds
    return None


class _Watch:
    __slots__ = ("fn", "last", "allow", "compiles", "unexpected")

    def __init__(self, fn, last):
        self.fn = fn
        self.last = last        # cache size at the last check
        self.allow = 1          # expected checks with growth not yet used
        self.compiles = 0       # growth observed since watch()
        self.unexpected = 0     # growth past the granted allowance


class CompileTracker:
    """Watches host caches and emits their growth as counters.

    Each ``watch()`` grants ONE expected check with growth: the first
    registration covers the first round's fill, and a re-watch at a
    declared boundary (the prune) covers the new shapes after it.
    """

    def __init__(self, tracer):
        self._tracer = tracer
        self._watched = {}

    def watch(self, name: str, fn) -> bool:
        """(Re)register ``fn`` under ``name``, granting one expected check
        with growth; entries already built at the first watch do not
        count.  Returns False (not watched) if ``fn`` has no cache that
        :func:`cache_size` reads."""
        size = cache_size(fn)
        if size is None:
            self._watched.pop(name, None)
            return False
        prev = self._watched.get(name)
        if prev is not None and prev.fn is fn:
            prev.allow += 1                  # declared boundary
            return True
        self._watched[name] = _Watch(fn, size)
        return True

    def check(self, **attrs) -> int:
        """Poll every watched cache; emit a ``compile/<name>`` counter per
        grown cache and return the entries of this check's *unexpected*
        growth (growth in a check past the granted allowance)."""
        unexpected_total = 0
        for name, w in self._watched.items():
            cur = cache_size(w.fn)
            if cur is None:
                continue
            if cur < w.last:                 # cleared: count from here
                w.last = cur
            if cur == w.last:
                continue
            delta = cur - w.last
            w.last = cur
            unexpected = 0
            if w.allow > 0:
                w.allow -= 1
            else:
                unexpected = delta
            w.compiles += delta
            w.unexpected += unexpected
            unexpected_total += unexpected
            self._tracer.counter("compile/" + name, delta, total=cur,
                                 unexpected=unexpected, **attrs)
        return unexpected_total

    def watch_host_caches(self, prefix: str = "") -> None:
        """``watch`` each of :func:`host_caches` under ``prefix + name``."""
        for name, fn in host_caches().items():
            self.watch(prefix + name, fn)

    def rebase(self) -> None:
        """Take every watched cache's current size as its baseline without
        counting: for work off the watched path that fills the same
        caches (the eval hook samples at its own shapes)."""
        for w in self._watched.values():
            cur = cache_size(w.fn)
            if cur is not None:
                w.last = cur

    def compiles(self) -> int:
        """Total growth observed across the watched caches."""
        return sum(w.compiles for w in self._watched.values())

    def recompiles(self) -> int:
        """Growth past the granted allowances."""
        return sum(w.unexpected for w in self._watched.values())


def tracker_for(tracer, prefix: str = "") -> Optional[CompileTracker]:
    """A tracker on ``tracer`` watching the host caches (under
    ``prefix``), or None where the tracer is off or does not track
    compiles."""
    if not (tracer.enabled and getattr(tracer, "compile_tracking", False)):
        return None
    tracker = CompileTracker(tracer)
    tracker.watch_host_caches(prefix)
    return tracker
