"""Continuous-batching diffusion sampler server (``repro/serve/server.py``).

The server owns a ``(slots, H, W, C)`` batch of denoising states and a
per-slot step counter.  Each tick runs one U-Net forward over the whole
batch and one per-slot DDIM step, so requests at different depths share
a batch.  A finished slot emits its image and refills from the request
source; a source that times out (yields ``None``) or raises degrades
gracefully, with the condition recorded in ``ServeResult.faults``.

Per-request determinism: a request's x_T, and for eta > 0 its per-step
noise z, come from a ``torch.Generator`` on the serving device seeded by
``Request.seed``, so its image does not depend on the slot that serves
it or on what ran there before.  ``Request.x_init`` injects x_T instead
(the parity tests hand both packages the same draw).

``tracer=`` (:mod:`repro_torch.obs`) records each tick as a
``serve/tick`` span, measured after the tick's synchronize, and source
faults as ``serve/fault`` events; it watches the host caches for growth
after the first tick (``compile/tick/<cache>`` counters).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.diffusion.ddim import ddim_step, ddim_timesteps
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.experiment.resolve import resolve_precision
from repro_torch.models.ops import cast_floats, compute_dtype
from repro_torch.models.unet import apply_unet
from repro_torch.obs.compile_tracker import (cache_size, host_caches,
                                             tracker_for)
from repro_torch.obs.trace import NULL_TRACER


@dataclass(frozen=True)
class Request:
    """One image to sample.  ``seed`` determines the output; ``x_init``
    (an (H, W, C) array) replaces the seeded x_T draw."""
    rid: int
    seed: int = 0
    x_init: Optional[np.ndarray] = field(default=None, compare=False,
                                         repr=False)


@dataclass
class ServeResult:
    images: Dict[int, np.ndarray] = field(default_factory=dict)
    step_latencies_s: List[float] = field(default_factory=list)
    request_latencies_s: Dict[int, float] = field(default_factory=dict)
    faults: List[str] = field(default_factory=list)
    seconds: float = 0.0

    def latency_percentile(self, q: float) -> float:
        """Per-step latency percentile in seconds (q in [0, 100])."""
        if not self.step_latencies_s:
            return float("nan")
        return float(np.percentile(np.asarray(self.step_latencies_s), q))

    @property
    def requests_per_s(self) -> float:
        n = len(self.images)
        return n / self.seconds if self.seconds > 0 else float("inf")


RequestSource = Union[Iterable, Iterator, Callable[[], Optional[Request]]]


class DiffusionServer:
    """Slot-based continuous-batching DDIM (eta=0) / DDPM-like (eta>0)
    sampler over a trained, optionally mask-pruned, U-Net.

    ``masks``: host numpy masks (``masks_for_ratio``) serve the pruned
    model through the gather route; ``None`` serves dense.  Under bf16
    the weights are cast once here and activations at each GEMM; the
    denoising state and the schedule stay fp32.  ``tracer``: a
    :class:`repro_torch.obs.Tracer` (or :meth:`bind_tracer` later).
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 num_steps: int = 10, eta: float = 0.0, masks=None,
                 precision: str = "", tracer=None, device="cuda"):
        self.device = resolve_device(device)
        self.precision = resolve_precision(precision or cfg.precision)
        self.cfg = cfg = cfg.replace(precision=self.precision)
        dt = compute_dtype(self.precision)
        self.params = cast_floats(params, dt) if dt != torch.float32 \
            else params
        self.slots = slots
        self.num_steps = num_steps
        self.eta = eta
        self.masks = masks
        self.sched = linear_schedule(cfg.diffusion_steps, device=self.device)
        self.ts = ddim_timesteps(cfg.diffusion_steps, num_steps)
        self.ts_prev = np.append(self.ts[1:], -1)
        self.shape = (slots, cfg.image_size, cfg.image_size, cfg.in_channels)
        self.x = torch.zeros(self.shape, device=self.device)
        # step counters live on the host: the tick's control flow needs
        # them there, and a device copy would force a sync every tick
        self.sidx = np.zeros((slots,), np.int64)
        self._gens: List[Optional[torch.Generator]] = [None] * slots
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._admit_t = [0.0] * slots
        self.step_latencies_s: List[float] = []
        self.request_latencies_s: Dict[int, float] = {}
        # the host caches' entries so far: compile_count() counts from here
        self._caches0 = self._cache_entries()
        # obs: NULL_TRACER (the default) makes every span a no-op
        self._obs = NULL_TRACER
        self._obs_compile = None
        if tracer is not None:
            self.bind_tracer(tracer)

    def bind_tracer(self, tracer) -> None:
        """Attach (or detach, with None) an obs tracer: ticks emit
        ``serve/tick`` spans, and the host caches are watched under
        ``tick/<cache>``, the first tick's fill expected and any growth
        after it not."""
        self._obs = tracer if tracer is not None else NULL_TRACER
        self._obs_compile = tracker_for(self._obs, prefix="tick/")

    @staticmethod
    def _cache_entries() -> int:
        return sum(cache_size(fn) for fn in host_caches().values())

    def compile_count(self) -> int:
        """Entries the host caches (matmul plans, group-L2 tables, nvcc
        builds) built since this server was made: what the port builds at
        run time where the reference compiles its tick.  It stops
        growing after the first tick, since occupancy and depth are
        data, not shapes (on the CPU the plain versions build none)."""
        return self._cache_entries() - self._caches0

    # -- request lifecycle ---------------------------------------------------
    def free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is None]

    def active_count(self) -> int:
        return self.slots - len(self.free_slots())

    def submit(self, req: Request) -> bool:
        """Admit a request into a free slot; False if the batch is full."""
        free = self.free_slots()
        if not free:
            return False
        s = free[0]
        gen = torch.Generator(self.device)
        gen.manual_seed(req.seed)
        if req.x_init is not None:
            x0 = torch.as_tensor(np.asarray(req.x_init, np.float32),
                                 device=self.device)
            if x0.shape != self.shape[1:]:
                raise ValueError(f"x_init shape {tuple(x0.shape)} != "
                                 f"{self.shape[1:]}")
        else:
            x0 = torch.randn(self.shape[1:], generator=gen,
                             device=self.device)
        self.x[s] = x0
        self.sidx[s] = 0
        self._gens[s] = gen
        self._slot_req[s] = req
        self._admit_t[s] = time.perf_counter()
        return True

    def kill(self, rid: int) -> bool:
        """Drop an in-flight request without emitting it; the slot is
        refillable at once (a new request overwrites its state)."""
        for s, r in enumerate(self._slot_req):
            if r is not None and r.rid == rid:
                self._slot_req[s] = None
                return True
        return False

    # -- the denoising tick --------------------------------------------------
    def _tick(self, active: np.ndarray) -> None:
        idx = np.minimum(self.sidx, self.num_steps - 1)
        dev = self.device
        t = torch.as_tensor(self.ts[idx], device=dev)
        tp = torch.as_tensor(self.ts_prev[idx], device=dev)
        eps = apply_unet(self.params, self.cfg, self.x, t, masks=self.masks)
        z = None
        if self.eta != 0.0:
            # one draw per live slot from its own generator, so a slot's
            # stream does not depend on its neighbours
            z = torch.zeros(self.shape, device=dev)
            for s in np.nonzero(active)[0]:
                z[s] = torch.randn(self.shape[1:], generator=self._gens[s],
                                   device=dev)
        x_new = ddim_step(self.x, t, tp, eps, self.sched, eta=self.eta, z=z)
        guard = torch.as_tensor(active, device=dev).reshape(-1, 1, 1, 1)
        self.x = torch.where(guard, x_new, self.x)
        self.sidx = self.sidx + active

    def step(self) -> List[Tuple[int, np.ndarray]]:
        """One denoising tick over the slot batch; returns the
        ``(rid, image)`` pairs that completed this tick."""
        active = np.array([r is not None for r in self._slot_req])
        t0 = time.perf_counter()
        self._tick(active)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.step_latencies_s.append(now - t0)
        self._obs.record_span("serve/tick", t0, now,
                              active=int(active.sum()))
        if self._obs_compile is not None:
            self._obs_compile.check()
        completed = []
        for s, req in enumerate(self._slot_req):
            if req is not None and self.sidx[s] >= self.num_steps:
                # a copy: on the CPU .numpy() would alias the slot, which
                # the next admission overwrites in place
                completed.append((req.rid, self.x[s].cpu().numpy().copy()))
                self.request_latencies_s[req.rid] = now - self._admit_t[s]
                self._slot_req[s] = None
        return completed

    # -- serving loop --------------------------------------------------------
    def run(self, requests: RequestSource, *, idle_limit: int = 100,
            fault_limit: int = 100) -> ServeResult:
        """Serve until the source is exhausted and all slots drain.

        The source is an iterable of :class:`Request` or a callable; it
        may yield ``None`` (no request right now) or raise (a fault).
        ``idle_limit`` consecutive empty polls with an empty batch, or
        ``fault_limit`` consecutive faults, end the run with the
        condition recorded in ``result.faults``.
        """
        res = ServeResult()
        pull = requests if callable(requests) else iter(requests).__next__
        exhausted = False
        idle = faults_in_a_row = 0
        n0_steps = len(self.step_latencies_s)
        t_start = time.perf_counter()
        while True:
            while not exhausted and self.free_slots():
                try:
                    req = pull()
                except StopIteration:
                    exhausted = True
                    break
                except Exception as e:          # queue fault
                    res.faults.append(f"request source fault: {e!r}")
                    self._obs.event("serve/fault", kind="source",
                                    detail=repr(e))
                    faults_in_a_row += 1
                    if faults_in_a_row >= fault_limit:
                        res.faults.append("fault limit reached; treating "
                                          "source as exhausted")
                        self._obs.event("serve/fault", kind="fault_limit")
                        exhausted = True
                    continue
                faults_in_a_row = 0
                if req is None:                 # timeout/empty poll
                    break
                self.submit(req)
            if self.active_count() == 0:
                if exhausted:
                    break
                idle += 1
                if idle >= idle_limit:
                    res.faults.append("idle limit reached with empty "
                                      "source; stopping")
                    self._obs.event("serve/fault", kind="idle_limit")
                    break
                continue
            idle = 0
            for rid, img in self.step():
                res.images[rid] = img
        res.seconds = time.perf_counter() - t_start
        res.step_latencies_s = self.step_latencies_s[n0_steps:]
        res.request_latencies_s = dict(self.request_latencies_s)
        self._obs.flush()
        return res
