"""Flat (single-tier) FL baselines (``repro/fl/baselines.py``; the paper's
Table II): FedAvg, FedProx (proximal term), FedDiffuse (only the encoder
half is shared), MOON (model-contrastive term) and SCAFFOLD (control
variates), plus centralized training with an EMA.  All share the client
substrate of :mod:`repro_torch.fl.client`.

Every method runs on either round engine, chosen per round as FedPhD
chooses (``engine=``):

  "sequential"  one client after another, one step a batch, the
                aggregation in Python (:func:`repro_torch.fl.client.run_local`);
  "vectorized"  the round's clients in client-batched steps, the E = 1
                case of :func:`repro_torch.fl.engine.make_round_engine`
                with the method's anchors in its ``ctx``, SCAFFOLD's
                c_i+ rows and their mean on the device;
  "auto"        vectorized whenever the round's clients share a batch
                shape, else sequential, warning once.

Method state that outlives a round (MOON's previous local models,
FedDiffuse's local decoder halves, SCAFFOLD's fp32 c_i and, with
``persistent_opt``, each client's Adam moments) lives in stacked (N, ...)
buffers gathered and scattered by the round's participants, on the card
or the host (:func:`repro_torch.fl.engine.resolve_store`).  Both engines
read and write the same buffers, so "auto" may switch engines between
rounds.  A client never seen before starts its MOON previous model and
its FedDiffuse decoder from the global model.

The host streams (participant sampling, each client's shuffle) consume
the reference's draws in its order, so selections and bytes match it
exactly; the model's own randomness (init, DDPM t and eps, MOON's
feature noise) comes from one ``torch.Generator`` seeded by
``rng_seed``, and both engines draw it in the same order.  ``state()``
and ``restore()`` use the reference's keys, plus the generator's state.

Faults (``fault=``) and the quantized uplink (``quant=``) act as in
:mod:`repro_torch.core.hfl`: budgets truncate local training, only
on-time reporters enter the aggregate and update their error-feedback
rows, only completed clients update their client-local state, and
``aggregation="staleness"`` (FedAvg only) merges late deltas a round
later.  SCAFFOLD's variates and late deltas ship in fp32; MOON's and
FedDiffuse's client-local state is never quantized.

Rounds split into ``_start_round`` and ``_finish_round`` and ``run()``
double-buffers them, as :class:`repro_torch.core.hfl.FedPhD` does: the
vectorized round's (C,) losses stay on the device until the round is
finished, and ``tracer=`` records the same phase spans.

Not ported yet, and refused: meshes (ROADMAP A.13).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import (aggregate_fedavg, fedavg_weights,
                                          uniform_weights, weighted_average,
                                          weighted_average_stacked)
from repro_torch.core.hfl import prng_key, run_pipelined, sync_losses
from repro_torch.data.pipeline import stack_round
from repro_torch.device import host_to_device, resolve_device
from repro_torch.experiment.resolve import resolve_engine, resolve_precision
from repro_torch.fl import engine as eng
from repro_torch.fl.client import (Client, make_local_step, run_local,
                                   scaffold_update)
from repro_torch.fl.comm import CommModel
from repro_torch.fl.compress import (QUANTS, downlink_bytes, ef_roundtrip,
                                     uplink_bytes)
from repro_torch.fl.faults import (FaultSpec, edge_weight_rows, late_delta,
                                   late_shares, make_fault_model,
                                   merge_late)
from repro_torch.fl.record import RoundRecord, RunResult, evals_of
from repro_torch.models import model
from repro_torch.obs.compile_tracker import tracker_for
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim import adam_init, ema_init, ema_update
from repro_torch.tree import tree_leaves, tree_map

FLAT_METHODS = ("fedavg", "fedprox", "feddiffuse", "moon", "scaffold")
AGGREGATIONS = ("fedavg", "staleness")

# FedDiffuse's partition of the U-Net: the encoder half (and the time
# embedding) is shared and aggregated, the decoder stays on the client
# (de Goede et al.'s "UDEC" variant, mirrored).
_SHARED_KEYS_UNET = ("conv_in", "temb1", "temb2", "down", "mid")


def _split_shared(params: Dict, cfg: ModelConfig):
    """``(shared, local)`` halves of a model, each in its key order."""
    if cfg.arch_type == "unet":
        shared = {k: v for k, v in params.items() if k in _SHARED_KEYS_UNET}
        local = {k: v for k, v in params.items()
                 if k not in _SHARED_KEYS_UNET}
        return shared, local
    # transformers: everything but the head and the final norm is shared
    local_keys = ("final_norm", "lm_head")
    shared = {k: v for k, v in params.items() if k not in local_keys}
    local = {k: v for k, v in params.items() if k in local_keys}
    return shared, local


def _merge(shared: Dict, local: Dict, like: Dict) -> Dict:
    """The two halves as one model in ``like``'s key order.  The port's
    trees keep insertion order (where ``jax.tree`` sorts keys), so the
    merged model must keep the model's own order: leaf order decides
    the summation order of the clip norm and of ``tree_sq_dist``."""
    return {k: shared[k] if k in shared else local[k] for k in like}


def shared_fraction(params: Dict, cfg: ModelConfig) -> float:
    shared, local = _split_shared(params, cfg)
    sb = sum(x.numel() for x in tree_leaves(shared))
    lb = sum(x.numel() for x in tree_leaves(local))
    return sb / max(sb + lb, 1)


@dataclasses.dataclass
class FlatFLResult:
    """``run_flat_fl``'s result: the round records and the final model."""
    history: List[RoundRecord]
    params: Dict


def _rows_or_default(rows, default_tree, seen_rows):
    """Each client's stored row if it took part before, else the current
    global value (the sequential path's ``dict.get(cid, params)``).
    ``rows`` are a gather's fresh copies, filled in place."""
    unseen = np.flatnonzero(~np.asarray(seen_rows, bool))
    if unseen.size == 0:
        return rows

    def fill(r, g):
        r[host_to_device(unseen, r.device)] = g.to(r.device)
        return r
    return tree_map(fill, rows, default_tree)


class FlatTrainer:
    """Round-stepped flat-FL trainer of ``method`` (``FLAT_METHODS``) on
    ``device`` (``"cuda"``, the default: the kernels; ``"cpu"``: their
    plain versions).

    engine: "vectorized", "sequential", "auto", or None (the default):
    ``$FEDPHD_ENGINE`` if set, else "auto"; an explicit "vectorized"
    raises on ragged clients.  persistent_opt: carry each client's Adam
    moments across rounds (off by default: the paper's baselines restart
    Adam every round).  state_store: where the (N, ...) method state
    lives, "device", "host" or "auto".  eval_fn/eval_every, fault and
    quant: as FedPhD's.  aggregation: "fedavg", or "staleness" for
    FedAvg.  tracer: a :class:`repro_torch.obs.Tracer`, as FedPhD's.
    mesh: the reference's; anything but None raises NotImplementedError
    (ROADMAP A.13).
    """

    def __init__(self, method: str, cfg: ModelConfig, fl: FLConfig,
                 clients: List[Client], *, lr: float = 2e-4,
                 rng_seed: int = 0, engine: Optional[str] = None,
                 persistent_opt: bool = False, state_store: str = "auto",
                 mesh=None, eval_fn: Optional[Callable] = None,
                 eval_every: int = 0,
                 aggregation: str = "fedavg",
                 fault: Optional[FaultSpec] = None,
                 quant: str = "none", tracer=None, device="cuda"):
        if method not in FLAT_METHODS:
            raise ValueError(f"method {method!r} not in {FLAT_METHODS}")
        if quant not in QUANTS:
            raise ValueError(f"unknown quant {quant!r}; expected one of "
                             f"{QUANTS}")
        if aggregation not in AGGREGATIONS:
            raise ValueError(f"unknown flat aggregation {aggregation!r}")
        if aggregation == "staleness" and method != "fedavg":
            raise ValueError("staleness aggregation is a FedAvg variant "
                             f"(got method={method!r})")
        if mesh is not None:
            raise NotImplementedError("FlatTrainer(mesh=...): the "
                                      "mesh-sharded client axis is "
                                      "ROADMAP A.13")
        # NULL_TRACER (the default): every span and event is a no-op
        self._obs = NULL_TRACER
        self._obs_compile = None
        self.method = method
        # "staleness": FedAvg over the on-time reporters and the late
        # deltas merged a round later; with no stragglers, FedAvg
        self.aggregation = aggregation
        self.quant = quant
        self.device = resolve_device(device)
        self.cfg = cfg = cfg.replace(
            precision=resolve_precision(cfg.precision))
        self.fl = fl
        self.clients = clients
        self.lr = lr
        self.engine, self._engine_strict = resolve_engine(engine)
        self._warned_ragged = False
        self.persistent_opt = persistent_opt
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.rng_seed = rng_seed
        self.fault = fault if (fault is not None and fault.enabled) else None
        self._faults = make_fault_model(self.fault, len(clients), rng_seed)
        self._late_buf = None        # one edge, one buffered late delta
        self.np_rng = np.random.default_rng(rng_seed)
        self.gen = torch.Generator(self.device)
        self.gen.manual_seed(rng_seed)
        self.params = model.init(cfg, self.gen, device=self.device)
        self.comm = CommModel()
        self.step_fn = make_local_step(cfg, fl, method=method, lr=lr)
        self._opt_zero = adam_init(self.params)
        # host seconds of every sequential local step and of every
        # vectorized round's local training, as FedPhD keeps them
        self.step_seconds: List[float] = []
        self.round_seconds: List[float] = []
        self._t_local: Optional[float] = None

        n = len(clients)
        self._store = eng.resolve_store(
            state_store, n, max(1, round(fl.participation * n)))
        host = self._store == "host"
        self._opt_stack = eng.stacked_adam_init(self.params, n, host=host) \
            if persistent_opt else None
        # method state with a leading (N,) client axis; ``seen`` marks
        # the clients that took part (an unseen row reads the global
        # model)
        self.c_global = tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), self.params) \
            if method == "scaffold" else None
        self._c_local_stack = eng.stacked_zeros(
            self.params, n, dtype=torch.float32, host=host) \
            if method == "scaffold" else None
        self._prev_stack = eng.stacked_zeros(self.params, n, host=host) \
            if method == "moon" else None
        self._local_stack = eng.stacked_zeros(
            _split_shared(self.params, cfg)[1], n, host=host) \
            if method == "feddiffuse" else None
        # the quantized uplink's per-client fp32 error-feedback rows
        self._err_stack = eng.stacked_zeros(
            self.params, n, dtype=torch.float32, host=host) \
            if quant != "none" else None
        self._seen = np.zeros(n, bool)
        self.history: List[RoundRecord] = []
        self._round_engine = eng.make_round_engine(
            cfg, fl, method=method, lr=lr, stored=self._stored_copies(),
            quant=quant)
        if tracer is not None:
            self.bind_tracer(tracer)

    # -- observability -------------------------------------------------------
    def bind_tracer(self, tracer) -> None:
        """Attach an obs tracer (:mod:`repro_torch.obs`): later rounds emit
        phase spans, fault events and host-cache counters through it.
        None (or the NULL_TRACER) keeps the no-op path.  The flat model
        never changes shape, so each cache is watched once."""
        self._obs = tracer if tracer is not None else NULL_TRACER
        self._obs_compile = tracker_for(self._obs)

    def _stored_copies(self) -> int:
        """fp32 model copies this trainer keeps on the card across
        rounds, for the engine's chunk size (the decoder rows counted
        as whole models)."""
        n = len(self.clients)
        rows = 0 if self._store == "host" else n * (
            (self.method in ("moon", "scaffold", "feddiffuse"))
            + 2 * self.persistent_opt + (self.quant != "none"))
        return rows + (self.method == "scaffold") \
            + (self.aggregation == "staleness")

    # -- engine routing and state rows ---------------------------------------
    def _use_vectorized(self, round_clients) -> bool:
        use, self._warned_ragged = eng.route_engine(
            self.engine, self._engine_strict, round_clients,
            self._warned_ragged, "FlatTrainer", method=self.method)
        return use

    def _rows(self, stack, idx):
        """Rows ``idx`` of a stacked state, on the device."""
        return eng.store_tree(eng.tree_gather(stack, idx), "device",
                              self.device)

    # -- the sequential engine ----------------------------------------------
    def _round_sequential(self, sel, faults=None):
        """One client after another.  Under ``faults`` a client runs its
        budget of steps, only on-time reporters enter the FedAvg
        aggregate, only completed clients update their local state, and
        late clients feed the staleness buffer."""
        method, fl, cfg, params = self.method, self.fl, self.cfg, self.params
        shared_g, local_g = _split_shared(params, cfg)
        client_models, counts, losses, c_deltas = [], [], [], []
        late_models, late_counts = [], []
        for cid in sel:
            cid = int(cid)
            cl = self.clients[cid]
            budget = faults.budget_of(cid) if faults else None
            completed = faults is None or faults.completed_of(cid)
            reporting = faults is None or faults.reporting_of(cid)
            start = params
            if method == "feddiffuse" and self._seen[cid]:
                start = _merge(shared_g, self._rows(self._local_stack, cid),
                               params)
            ctx = {}
            if method in ("fedprox", "moon"):
                ctx["global_params"] = params
            if method == "moon":
                ctx["prev_params"] = self._rows(self._prev_stack, cid) \
                    if self._seen[cid] else params
            if method == "scaffold":
                ctx["c_local"] = self._rows(self._c_local_stack, cid)
                ctx["c_global"] = self.c_global
            opt_in = self._rows(self._opt_stack, cid) \
                if self.persistent_opt else self._opt_zero
            new_p, opt_out, loss = run_local(
                self.step_fn, start, cl, epochs=fl.local_epochs,
                generator=self.gen, ctx=ctx or None, opt_state=opt_in,
                max_steps=budget, step_seconds=self.step_seconds)
            losses.append(loss)
            if self.persistent_opt and completed:
                eng.tree_scatter(self._opt_stack, cid, opt_out)
            if method == "moon" and completed:
                eng.tree_scatter(self._prev_stack, cid, new_p)
                self._seen[cid] = True
            if method == "feddiffuse" and completed:
                eng.tree_scatter(self._local_stack, cid,
                                 _split_shared(new_p, cfg)[1])
                self._seen[cid] = True
            if reporting:
                counts.append(cl.n_samples)
                up_p = new_p
                if self.quant != "none":
                    # the server decodes start + deq; the client-local
                    # state above keeps the true new_p.  The delta's base
                    # is the client's own start (FedDiffuse: with its
                    # decoder rows), as the engine's
                    up_p, new_err = ef_roundtrip(
                        new_p, self._rows(self._err_stack, cid), self.quant,
                        start=start)
                    eng.tree_scatter(self._err_stack, cid, new_err)
                client_models.append(_split_shared(up_p, cfg)[0]
                                     if method == "feddiffuse" else up_p)
            elif faults is not None and faults.late_of(cid):
                late_models.append(new_p)
                late_counts.append(cl.n_samples)
            if method == "scaffold" and completed:
                # c_i+ = c_i - c + (x - y_i) / (K lr), K the client's
                # executed steps (at least 1: a 0-step budget's zero
                # delta must not meet an infinite scale)
                steps = budget if faults else \
                    fl.local_epochs * cl.data.steps_per_epoch
                ci = ctx["c_local"]
                new_ci = scaffold_update(ci, self.c_global, start, new_p,
                                         1.0 / (max(steps, 1) * self.lr))
                c_deltas.append(tree_map(lambda a, b: a - b, new_ci, ci))
                eng.tree_scatter(self._c_local_stack, cid, new_ci)
        # no reporter: the server keeps its model
        agg = aggregate_fedavg(client_models, counts) if client_models \
            else (shared_g if method == "feddiffuse" else params)
        if self.aggregation == "staleness":
            buf, self._late_buf = self._late_buf, None
            agg = merge_late(agg, buf, self.fault)
            if late_models:
                self._late_buf = late_delta(late_models, params,
                                            late_shares(counts, late_counts))
        self.params = _merge(agg, local_g, params) \
            if method == "feddiffuse" else agg
        if method == "scaffold" and c_deltas:
            mean_dc = weighted_average(c_deltas,
                                       uniform_weights(len(c_deltas)))
            frac = len(c_deltas) / len(self.clients)
            self.c_global = tree_map(lambda c, d: c + frac * d,
                                     self.c_global, mean_dc)
        return losses

    # -- the vectorized engine ----------------------------------------------
    def _round_vectorized(self, sel, faults=None, r=0):
        """The E = 1 engine round.  Under ``faults`` the budgets truncate
        the (C, S) valid mask by a prefix, clients that do not report get
        zero weight (the reporters' renormalized), and late deltas come
        back through ``w_late``.  Returns the (C,) losses on the
        device."""
        method, fl, cfg, params = self.method, self.fl, self.cfg, self.params
        obs = self._obs
        with obs.span("round/host_prep", round=r):
            sel_arr = np.asarray(sel)
            sel_clients = [self.clients[int(c)] for c in sel]
            counts = np.asarray([cl.n_samples for cl in sel_clients])
            # the schedule's masks are in selection order
            everyone = np.ones(len(sel), bool)
            rep = everyone if faults is None else faults.reporting
            comp = everyone if faults is None else faults.completed
            batches, valid = stack_round([cl.data for cl in sel_clients],
                                         fl.local_epochs)
            if faults is not None:
                valid = faults.truncate(valid, sel)
        self._t_local = time.perf_counter()
        with obs.span("round/h2d", round=r):
            batches = {k: host_to_device(v, self.device)
                       for k, v in batches.items()}
            draws = eng.draw_round(self.gen, valid,
                                   batches["images"].shape[2:],
                                   cfg.diffusion_steps, self.device,
                                   features=method == "moon")
        # the flat round is the E = 1 case of the edge engine; the one
        # edge model is a view of the global model
        server = tree_map(lambda leaf: leaf[None], params)
        late = np.zeros(len(sel), bool) if faults is None else faults.late
        w_row, w_late = edge_weight_rows(
            np.zeros(len(sel), np.int64), 1, counts, rep, late,
            lambda mask: fedavg_weights(counts[mask]))
        shared_g, local_g = _split_shared(params, cfg)
        seen = self._seen[sel_arr]
        ctx = None
        if method in ("fedprox", "moon"):
            ctx = {"global_params": params}
        if method == "moon":
            ctx["prev_params"] = _rows_or_default(
                self._rows(self._prev_stack, sel_arr), params, seen)
        if method == "feddiffuse":
            ctx = {"local_params": _rows_or_default(
                self._rows(self._local_stack, sel_arr), local_g, seen)}
        if method == "scaffold":
            steps = faults.budget.astype(np.float64) if faults is not None \
                else np.asarray([fl.local_epochs * cl.data.steps_per_epoch
                                 for cl in sel_clients], np.float64)
            scale = 1.0 / (np.maximum(steps, 1) * self.lr)
            ctx = {"c_local": self._rows(self._c_local_stack, sel_arr),
                   "c_global": self.c_global,
                   "scale": host_to_device(scale.astype(np.float32),
                                           self.device)}
        with obs.span("round/dispatch", round=r):
            out = self._round_engine(
                server, np.zeros(len(sel), np.int64), batches, valid, draws,
                w_row, ctx=ctx,
                opt_states=self._rows(self._opt_stack, sel_arr)
                if self.persistent_opt else None, w_late=w_late,
                err=self._rows(self._err_stack, sel_arr)
                if self.quant != "none" else None)
        # under faults SCAFFOLD's mean change is taken over the completed
        # clients, which needs their old rows
        c_local = ctx["c_local"] if method == "scaffold" \
            and faults is not None else None
        del ctx
        # a zero weight row makes the aggregate zeros: keep the model
        agg = tree_map(lambda leaf: leaf[0], out["agg"]) if rep.any() \
            else (shared_g if method == "feddiffuse" else params)
        if self.aggregation == "staleness":
            buf, self._late_buf = self._late_buf, None
            agg = merge_late(agg, buf, self.fault)
            if w_late is not None:
                self._late_buf = tree_map(lambda leaf: leaf[0], out["late"])

        if self.quant != "none":
            # only on-time reporters sent a quantized payload
            eng.scatter_rows(self._err_stack, sel_arr, out["err"], rep)
        if self.persistent_opt:
            eng.scatter_rows(self._opt_stack, sel_arr, out["opt"], comp)
        if method == "moon":
            eng.scatter_rows(self._prev_stack, sel_arr, out["trained"], comp)
            self._seen[sel_arr[comp]] = True
        if method == "feddiffuse":
            eng.scatter_rows(self._local_stack, sel_arr,
                             {k: out["trained"][k] for k in local_g}, comp)
            self._seen[sel_arr[comp]] = True
            # only the shared half of the aggregate is used; the server
            # keeps its own decoder (never communicated)
            self.params = _merge({k: agg[k] for k in shared_g}, local_g,
                                 params)
        else:
            self.params = agg
        if method == "scaffold" and comp.any():
            eng.scatter_rows(self._c_local_stack, sel_arr, out["c_new"],
                             comp)
            if faults is None:
                mean_dc = out["dc_mean"]
            else:
                # the engine's mean is over every client: take it over
                # the completed ones
                dc = tree_map(lambda a, b: a - b, out["c_new"], c_local)
                mean_dc = weighted_average_stacked(
                    dc, comp.astype(np.float64) / comp.sum())
            frac = int(comp.sum()) / len(self.clients)
            self.c_global = tree_map(lambda c, d: c + frac * d,
                                     self.c_global, mean_dc)
        # no sync: the losses stay on the device until _finish_round
        return out["losses"]

    # -- one round -----------------------------------------------------------
    def late_buffers(self) -> Dict[int, dict]:
        """The buffered late-delta sum (staleness) as FedPhD's one edge
        would hold it: ``{0: tree}``, or empty."""
        return {} if self._late_buf is None else {0: self._late_buf}

    def _wire_bytes(self):
        """``(up, up_full, down)`` bytes of one transfer: the on-time
        uplink (quantized: payload and scales), the fp32 uplink of late
        clients, and the download.  Only the part a method sends counts
        (FedDiffuse's shared half), and SCAFFOLD adds its fp32 control
        variates both ways, never quantized."""
        comm_tree = _split_shared(self.params, self.cfg)[0] \
            if self.method == "feddiffuse" else self.params
        up_q = uplink_bytes(comm_tree, self.quant)
        up_f = uplink_bytes(comm_tree, "none")
        down = downlink_bytes(comm_tree, self.cfg.precision)
        if self.method == "scaffold":
            up_q += uplink_bytes(self.params, "none")
            up_f += uplink_bytes(self.params, "none")
            down += downlink_bytes(self.params, "fp32")
        return up_q, up_f, down

    def run_round(self, r: int) -> RoundRecord:
        return self._finish_round(self._start_round(r))

    def _start_round(self, r: int) -> Dict:
        """Sampling, local training, aggregation and the method's state:
        everything but the wait for the device's losses.  Returns the
        pending round ``_finish_round`` records."""
        fl = self.fl
        C = max(1, round(fl.participation * len(self.clients)))
        faults = None
        if self._faults is not None:
            # the churn first (its own stream), then the participants
            # from the online clients only
            pool = np.flatnonzero(self._faults.begin_round())
            C = min(C, len(pool))
            sel = pool[self.np_rng.choice(len(pool), size=C, replace=False)]
            steps = [fl.local_epochs
                     * self.clients[int(c)].data.steps_per_epoch for c in sel]
            faults = self._faults.draw_round(
                sel, steps, self.aggregation == "staleness")
            if self._obs.enabled:
                self._obs.event("fault/draw", round=r, **faults.summary())
        else:
            sel = self.np_rng.choice(len(self.clients), size=C,
                                     replace=False)
        self._t_local = None
        if self._use_vectorized([self.clients[int(c)] for c in sel]):
            losses = self._round_vectorized(sel, faults, r)
        else:
            # the sequential loop syncs every step: one dispatch span
            with self._obs.span("round/dispatch", round=r):
                losses = self._round_sequential(sel, faults)
        up_q, up_f, down = self._wire_bytes()
        if faults is None:
            up_bytes = len(sel) * self.comm.edge_cloud(up_q)
            down_bytes = len(sel) * self.comm.edge_cloud(down)
        else:
            # downloads to every arrived client, uploads from the ones
            # that finished: the quantized payload from on-time
            # reporters, fp32 from late ones
            n_rep = int(faults.reporting.sum())
            n_late = int(faults.completed.sum()) - n_rep
            up_bytes = n_rep * self.comm.edge_cloud(up_q) \
                + n_late * self.comm.edge_cloud(up_f)
            down_bytes = int(faults.arrived.sum()) \
                * self.comm.edge_cloud(down)
        # what the record and the eval hook read, taken now
        return {"round": r, "losses": losses, "t_local": self._t_local,
                "sel_ids": sel,
                "up_bytes": up_bytes, "down_bytes": down_bytes,
                "params_m": sum(x.numel()
                                for x in tree_leaves(self.params)) / 1e6,
                "params": self.params, "cfg": self.cfg,
                "loss_mask": [faults is None or faults.budget_of(int(c)) > 0
                              for c in sel],
                "availability": faults.availability() if faults else None}

    def _finish_round(self, pend: Dict) -> RoundRecord:
        """Sync the pending round's losses and append its record."""
        r = pend["round"]
        # the round's loss averages the clients that ran a step
        losses = [x for x, ran in zip(sync_losses(self, pend),
                                      pend["loss_mask"]) if ran]
        rec = RoundRecord(
            round=pend["round"],
            loss=float(np.mean(losses)) if losses else 0.0,
            comm_gb=pend["up_bytes"] / 1e9 + pend["down_bytes"] / 1e9,
            comm_up_gb=pend["up_bytes"] / 1e9,
            comm_down_gb=pend["down_bytes"] / 1e9,
            params_m=pend["params_m"],
            selected=[int(c) for c in pend["sel_ids"]],
            availability=pend["availability"])
        # appended before the eval hook: the round ran and the streams
        # advanced, so a raising eval_fn loses the eval, not the round
        self.history.append(rec)
        if self._obs_compile is not None:
            self._obs_compile.check(round=r)
        if self.eval_fn and self.eval_every and r % self.eval_every == 0:
            rec.eval = self.eval_fn(pend["params"], pend["cfg"], r)
            if self._obs_compile is not None:
                # the eval samples at its own shapes, off the watched path
                self._obs_compile.rebase()
        return rec

    def run(self, rounds: Optional[int] = None, *,
            eval_every: Optional[int] = None) -> RunResult:
        """Run rounds ``len(history)+1 .. rounds`` (default
        ``fl.rounds``; after ``restore`` the run continues), double-
        buffered (:func:`repro_torch.core.hfl.run_pipelined`)."""
        rounds = rounds or self.fl.rounds
        if eval_every is not None:
            self.eval_every = eval_every
        run_pipelined(self, rounds)
        return RunResult(self.history, evals_of(self.history))

    # -- checkpoint state (the experiment API's resume contract) -------------
    def state(self):
        """``(arrays, meta)`` in the reference's keys: the global model,
        the stacked method state, ``seen`` and every host stream; ``rng``
        is ``jax.random.PRNGKey(rng_seed)``'s pair and the model-noise
        stream is the generator's state, ``torch_rng`` (the port's
        own)."""
        arrays = {
            "params": self.params,
            "rng": prng_key(self.rng_seed),
            "opt_stack": self._opt_stack,
            "c_global": self.c_global,
            "c_local_stack": self._c_local_stack,
            "prev_stack": self._prev_stack,
            "local_stack": self._local_stack,
            "seen": self._seen,
            "late_buf": self._late_buf,
            "err_stack": self._err_stack,
            "torch_rng": self.gen.get_state().numpy(),
        }
        meta = {
            "trainer": "flat",
            "method": self.method,
            "np_rng": self.np_rng.bit_generator.state,
            "client_rngs": [cl.data.rng_state() for cl in self.clients],
            "history": [rec.to_dict() for rec in self.history],
            "fault": self._faults.state() if self._faults else None,
            "torch_rng_device": self.gen.device.type,
        }
        return arrays, meta

    def restore(self, arrays, meta) -> None:
        """Inverse of ``state()`` on a trainer built with the same
        arguments.  A reference checkpoint has no generator state: the
        generator stays as construction left it, with a warning."""
        if meta.get("method", self.method) != self.method:
            raise ValueError(f"checkpoint is for method "
                             f"{meta['method']!r}, trainer is "
                             f"{self.method!r}")
        saved = meta.get("torch_rng_device")
        if saved is not None and saved != self.gen.device.type:
            raise RuntimeError(
                f"the checkpoint's generator state is a {saved!r} "
                f"generator's and this trainer's is "
                f"{self.gen.device.type!r}: the two draw different "
                f"streams; resume on a {saved!r} device")
        to_store = lambda t: eng.store_tree(t, self._store, self.device)
        self.params = params_from_jax(arrays["params"], self.device)
        self._opt_zero = adam_init(self.params)
        self.c_global = None if arrays.get("c_global") is None else \
            params_from_jax(arrays["c_global"], self.device)
        self._c_local_stack = to_store(arrays.get("c_local_stack"))
        self._prev_stack = to_store(arrays.get("prev_stack"))
        self._local_stack = to_store(arrays.get("local_stack"))
        self._seen = np.asarray(arrays["seen"], bool).copy()
        self._late_buf = None if arrays.get("late_buf") is None else \
            params_from_jax(arrays["late_buf"], self.device)
        if self.quant != "none" and arrays.get("err_stack") is not None:
            self._err_stack = to_store(arrays["err_stack"])
        if self.persistent_opt:
            self._opt_stack = eng.adam_stack_from_tree(
                arrays["opt_stack"], self._store, self.device)
        self.np_rng.bit_generator.state = meta["np_rng"]
        for cl, st in zip(self.clients, meta["client_rngs"]):
            cl.data.set_rng_state(st)
        if self._faults is not None and meta.get("fault"):
            self._faults.set_state(meta["fault"])
        if arrays.get("torch_rng") is not None:
            self.gen.set_state(torch.from_numpy(
                np.asarray(arrays["torch_rng"], np.uint8)))
        else:
            warnings.warn("the checkpoint carries no torch generator "
                          "state (the JAX package wrote it): the model "
                          "noise stream continues from this trainer's "
                          "seed, not from the checkpoint",
                          RuntimeWarning)
        self.history = [RoundRecord.from_dict(d) for d in meta["history"]]


def run_flat_fl(method: str, cfg: ModelConfig, fl: FLConfig,
                clients: List[Client], *, rounds: Optional[int] = None,
                lr: float = 2e-4, rng_seed: int = 0,
                eval_fn: Optional[Callable] = None, eval_every: int = 0,
                engine: Optional[str] = None, persistent_opt: bool = False,
                device="cuda") -> FlatFLResult:
    """Deprecated front end: use ``repro_torch.experiment.run_spec`` or
    :class:`FlatTrainer`.  Runs ``method`` for ``rounds`` (default
    ``fl.rounds``) and returns the records and the final model."""
    warnings.warn(
        "run_flat_fl is deprecated; use repro_torch.experiment.run_spec(...)"
        " or FlatTrainer(...) directly", DeprecationWarning, stacklevel=2)
    trainer = FlatTrainer(method, cfg, fl, clients, lr=lr,
                          rng_seed=rng_seed, engine=engine,
                          persistent_opt=persistent_opt, eval_fn=eval_fn,
                          eval_every=eval_every, device=device)
    trainer.run(rounds or fl.rounds)
    return FlatFLResult(history=trainer.history, params=trainer.params)


def run_centralized(cfg: ModelConfig, images: np.ndarray, *, steps: int,
                    batch_size: int, lr: float = 2e-4, rng_seed: int = 0,
                    use_ema: bool = True, device="cuda"):
    """Centralized baseline (the paper: 500K steps with an EMA; scaled
    down here): ``steps`` Adam steps on batches drawn with replacement
    from ``images`` by a numpy stream seeded by ``rng_seed``, the EMA
    (decay 0.999, fp32) updated after each.  Returns ``(params,
    losses)``, the params the EMA's cast to the model's dtypes when
    ``use_ema``."""
    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(rng_seed)
    params = model.init(cfg, gen, device=dev)
    step = make_local_step(cfg, FLConfig(), lr=lr)
    opt_state = adam_init(params)
    ema = ema_init(params) if use_ema else None
    np_rng = np.random.default_rng(rng_seed)
    losses = []
    for _ in range(steps):
        sel = np_rng.integers(0, len(images), size=batch_size)
        batch = {"images": torch.as_tensor(images[sel], device=dev)}
        params, opt_state, loss = step(params, opt_state, batch, gen)
        losses.append(float(loss))
        if use_ema:
            ema = ema_update(ema, params, 0.999)
    if not use_ema:
        return params, losses
    return tree_map(lambda e, p: e.to(p.dtype), ema, params), losses
