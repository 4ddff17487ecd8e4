"""The FedPhD trainer (``repro/core/hfl.py``; paper Algorithm 1).

Three tiers: clients train locally from their edge's model, edges
aggregate them with homogeneity-aware (SH) weights every r_e rounds,
and the cloud aggregates the edges every r_g rounds and refreshes them.
Clients pick their edge by SH-driven selection (Eq. 25).  Rounds
r < R_s are sparse: the local loss adds the Omega group-lasso.  At the
first cloud aggregation with r >= R_s the cloud prunes once, by L2
group scores, and compacts the model; plain rounds continue on the
smaller U-Net.

The host numpy streams (participant sampling, edge selection, each
client's shuffle) consume the reference's draws in the reference's
order, so selections, edge assignments and byte counts match it
exactly.  The model's own randomness (init, DDPM t and eps) comes from
one ``torch.Generator`` seeded by ``rng_seed``: the reference's
``jax.random`` streams cannot be reproduced.

Local training runs on one of two engines, chosen per round as the
reference chooses: the vectorized engine (:mod:`repro_torch.fl.engine`:
the round's clients in one client-batched step a batch, one loss sync a
round) or the sequential one (a client at a time, one step a batch).
Both consume the generator's draws in the same order.

Faults (``fault=``, :mod:`repro_torch.fl.faults`) draw each round's
arrivals, dropouts and step budgets from a numpy stream of their own:
budgets truncate local training, only reporting clients enter their
edge's aggregate (an edge with none keeps its model), and under
``aggregation="staleness"`` a straggler's delta is buffered and merged
into its edge's next aggregate.  ``quant`` ("int8", "fp8") quantizes the
on-time clients' uplink with per-client error feedback
(:mod:`repro_torch.fl.compress`).

``eval_fn(params, cfg, round)`` runs every ``eval_every`` rounds after
the round's record is appended, its result in ``RoundRecord.eval``.

A round is two halves, as in the reference: ``_start_round`` selects,
stages the data, dispatches local training and aggregates; on the
vectorized engine nothing there waits for the device, and the round's
(C,) losses stay on it.  ``_finish_round`` syncs them (the round's one
sync) and appends the record.  ``run()`` double-buffers rounds: round
r+1 is dispatched before round r is finished, so the host's data prep
and upload for r+1 overlap r's device work; the numbers are those of a
``run_round`` loop, bit for bit.  ``tracer=`` (:mod:`repro_torch.obs`)
records each phase as a span (``round/host_prep``, ``round/h2d``,
``round/dispatch``, ``round/edge_agg``, ``round/cloud_agg``,
``round/prune``, ``round/loss_sync``), the fault draws as events and
the host caches' growth as counters.

``state()`` and ``restore()`` carry everything the trajectory depends
on, in the reference's keys and layout, so a checkpoint crosses between
the packages both ways; the port adds the generator's state
(``torch_rng``), the one stream that cannot cross.  A resumed run is
bitwise equal to an unbroken one on the CPU.

Not ported yet, and refused: meshes (ROADMAP A.13).
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import (FLConfig, ModelConfig,
                                      config_from_dict, config_to_dict)
from repro_torch.convert import params_from_jax
from repro_torch.core.aggregation import (aggregate_fedavg, aggregate_sh,
                                          fedavg_weights, sh_weights)
from repro_torch.core.pruning import (build_groups, compact, l2_scores,
                                      make_masks, random_scores)
from repro_torch.core.selection import random_selection, select_edge
from repro_torch.core.sh_score import (AccumulatedDistribution, sh_score,
                                       uniform_target)
from repro_torch.data.pipeline import stack_round
from repro_torch.device import host_to_device, resolve_device
from repro_torch.experiment.resolve import resolve_engine, resolve_precision
from repro_torch.fl.client import Client, make_local_step, run_local
from repro_torch.fl.comm import CommModel
from repro_torch.fl.compress import (QUANTS, downlink_bytes, ef_roundtrip,
                                     uplink_bytes)
from repro_torch.fl.engine import (adam_stack_from_tree, draw_round,
                                   make_round_engine, resolve_store,
                                   route_engine, scatter_rows, stack_trees,
                                   stacked_adam_init, stacked_zeros,
                                   store_tree, tree_gather, tree_scatter)
from repro_torch.fl.faults import (FaultSpec, edge_weight_rows, late_delta,
                                   late_shares, make_fault_model,
                                   merge_late)
from repro_torch.fl.record import RoundRecord, RunResult, evals_of
from repro_torch.models import model
from repro_torch.obs.compile_tracker import tracker_for
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.optim import adam_init
from repro_torch.tree import tree_leaves, tree_map

SELECTIONS = ("sh", "random")
AGGREGATIONS = ("sh", "fedavg", "staleness")


def prng_key(seed: int) -> np.ndarray:
    """The uint32 pair ``jax.random.PRNGKey(seed)`` holds with JAX's
    default 32-bit integers: 0 and the seed's low 32 bits.  ``state()``
    saves it as ``rng``, so the reference can load the port's
    checkpoint."""
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def sync_losses(trainer, pend: Dict) -> list:
    """A pending round's per-client losses on the host.  The vectorized
    engine's (C,) device losses are synced here, once (``round/loss_sync``),
    and the round's local seconds, from its upload to this sync, are
    appended to ``trainer.round_seconds``; the sequential engine's are a
    host list already."""
    losses = pend["losses"]
    if isinstance(losses, torch.Tensor):
        with trainer._obs.span("round/loss_sync", round=pend["round"]):
            losses = losses.tolist()
        trainer.round_seconds.append(time.perf_counter() - pend["t_local"])
    return losses


def run_pipelined(trainer, rounds: int) -> None:
    """Rounds ``len(history)+1 .. rounds`` of ``trainer`` (``FedPhD`` or
    ``FlatTrainer``), double-buffered: round r+1 is dispatched
    (``_start_round``) before round r is finished (``_finish_round``:
    its loss sync, record and eval), so the host's data prep and upload
    for r+1 overlap r's device work.  Records are finished in round
    order, and every number equals a ``run_round`` loop's."""
    pend = None
    try:
        for r in range(len(trainer.history) + 1, rounds + 1):
            cur = trainer._start_round(r)
            # cur is guarded before prev is finished: if prev's eval
            # raises, prev is in the history (appended before the eval)
            # and the finally still finishes cur
            prev, pend = pend, cur
            if prev is not None:
                trainer._finish_round(prev)
    finally:
        # a raising _start_round must not orphan the round dispatched
        # before it; finish it only where it extends the history without
        # a gap
        if pend is not None and len(trainer.history) == pend["round"] - 1:
            trainer._finish_round(pend)


class FedPhD:
    """The FedPhD trainer.

    selection: "sh" (Eq. 25) or "random"; aggregation: "sh" (Eqs.
    21-24), "fedavg", or "staleness" (FedAvg over the on-time reporters
    and the late deltas merged a round later).  ``prune=False`` trains
    the dense model
    throughout.  ``device`` is where the model trains: ``"cuda"`` (the
    default; the kernels) or ``"cpu"`` (their plain versions).

    engine: "vectorized" (:mod:`repro_torch.fl.engine`), "sequential"
    (one client at a time), "auto" (vectorized whenever the round's
    clients share a batch shape, else sequential, warning once), or
    None (the default): ``$FEDPHD_ENGINE`` if set, else "auto".  An
    explicit "vectorized" raises on ragged clients.
    persistent_opt: carry each client's Adam moments across rounds in a
    stacked (N, ...) state, gathered and scattered by the round's
    participants on either engine (off by default: the paper restarts
    Adam every round); reset at the prune, where the shapes change.
    state_store: where that state lives: "device", "host" (numpy; only
    the round's rows move to the device) or "auto"
    (:func:`repro_torch.fl.engine.resolve_store`).
    eval_fn/eval_every: ``eval_fn(params, cfg, round)`` is called every
    ``eval_every`` rounds and its result stored in ``RoundRecord.eval``.
    fault: a :class:`repro_torch.fl.faults.FaultSpec`; a disabled one is
    None.  quant: the uplink's dtype, "none", "int8" or "fp8".
    tracer: a :class:`repro_torch.obs.Tracer` (or :meth:`bind_tracer`
    later); None records nothing.  mesh: the reference's; anything but
    None raises NotImplementedError (ROADMAP A.13).
    """

    def __init__(self, cfg: ModelConfig, fl: FLConfig, clients: List[Client],
                 *, rng_seed: int = 0, selection: str = "sh",
                 aggregation: str = "sh", prune: bool = True,
                 lr: float = 2e-4, engine: Optional[str] = None,
                 persistent_opt: bool = False, state_store: str = "auto",
                 mesh=None, eval_fn: Optional[Callable] = None,
                 eval_every: int = 0, fault: Optional[FaultSpec] = None,
                 quant: str = "none", tracer=None, device="cuda"):
        # NULL_TRACER (the default) makes every span, event and counter
        # a no-op; tracing never draws, reads the device or syncs
        self._obs = NULL_TRACER
        self._obs_compile = None
        if mesh is not None:
            raise NotImplementedError("FedPhD(mesh=...): the mesh-sharded "
                                      "client axis is ROADMAP A.13")
        if quant not in QUANTS:
            raise ValueError(f"unknown quant {quant!r}; expected one of "
                             f"{QUANTS}")
        if selection not in SELECTIONS:
            raise ValueError(f"selection {selection!r} not in {SELECTIONS}")
        if aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation {aggregation!r} not in "
                             f"{AGGREGATIONS}")
        self.device = resolve_device(device)
        self.cfg = cfg.replace(precision=resolve_precision(cfg.precision))
        self.quant = quant
        self.fl = fl
        self.clients = clients
        self.selection = selection
        self.aggregation = aggregation
        self.prune = prune
        self.lr = lr
        self.engine, self._engine_strict = resolve_engine(engine)
        self._warned_ragged = False
        self.persistent_opt = persistent_opt
        self._store = resolve_store(
            state_store, len(clients),
            max(1, round(fl.participation * len(clients))))
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.rng_seed = rng_seed
        self.np_rng = np.random.default_rng(rng_seed)
        self.gen = torch.Generator(self.device)
        self.gen.manual_seed(rng_seed)
        # a disabled (or absent) spec makes no model: every fault branch
        # below falls back to the fault-free path
        self.fault = fault if (fault is not None and fault.enabled) else None
        self._faults = make_fault_model(self.fault, len(clients), rng_seed)
        # staleness: each edge's buffered late-delta sum, merged into its
        # next aggregate (dropped at the prune, where the shapes change)
        self._late_buf: Dict[int, dict] = {}

        num_classes = clients[0].num_classes
        self.q_u = uniform_target(num_classes)
        self.edges = [AccumulatedDistribution(num_classes)
                      for _ in range(fl.num_edges)]
        self.params = model.init(self.cfg, self.gen, device=self.device)
        self.groups = build_groups(self.cfg, self.params)
        self.comm = CommModel()
        self.history: List[RoundRecord] = []
        self.pruned = False
        self.prune_report: Optional[Dict[str, tuple]] = None
        # edge id -> the edge's model; None until the first edge aggregation
        self._edge_models: Optional[Dict[int, dict]] = None
        # host seconds of every sequential local step, each ending in its
        # loss sync, and of every vectorized round's local training, from
        # the batches' upload to the round's loss sync in _finish_round
        self.step_seconds: List[float] = []
        self.round_seconds: List[float] = []
        self._t_local: Optional[float] = None

        if prune and fl.prune_mode.startswith("oneshot"):
            self._prune_now(mode=fl.prune_mode)
        self._rebuild_steps()
        if tracer is not None:
            self.bind_tracer(tracer)

    # -- observability -------------------------------------------------------
    def bind_tracer(self, tracer) -> None:
        """Attach an obs tracer (:mod:`repro_torch.obs`): later rounds emit
        phase spans, fault events and host-cache counters through it.
        None (or the NULL_TRACER) keeps the no-op path."""
        self._obs = tracer if tracer is not None else NULL_TRACER
        self._obs_compile = tracker_for(self._obs)

    # -- pruning ------------------------------------------------------------
    def _prune_now(self, mode: str) -> None:
        if mode == "oneshot_random":
            scores = random_scores(self.gen, self.groups, device=self.device)
        else:                                 # group_norm or oneshot_l2
            scores = l2_scores(self.params, self.groups)
        masks = make_masks(scores, self.groups, self.fl.prune_ratio)
        self.params, self.cfg, self.prune_report = compact(
            self.params, self.cfg, self.groups, masks)
        self.groups = build_groups(self.cfg, self.params)
        self.pruned = True

    def _rebuild_steps(self) -> None:
        sparse = (self.prune and not self.pruned
                  and self.fl.prune_mode == "group_norm")
        self.step_sparse = make_local_step(
            self.cfg, self.fl, sparse=True, groups=self.groups,
            lr=self.lr) if sparse else None
        self.step_plain = make_local_step(self.cfg, self.fl, sparse=False,
                                          lr=self.lr)
        kw = dict(lr=self.lr, stored=self._stored_copies(),
                  quant=self.quant)
        self._engine_sparse = make_round_engine(
            self.cfg, self.fl, sparse=True, groups=self.groups,
            **kw) if sparse else None
        self._engine_plain = make_round_engine(self.cfg, self.fl,
                                               sparse=False, **kw)
        # one Adam zero-state per model shape, shared by every client of
        # the sequential engine
        self._opt_zero = adam_init(self.params)
        # persistent per-client moments: a stacked (N, ...) state both
        # engines gather and scatter by participation, reset (rebuilt as
        # zeros) whenever pruning changes the parameter shapes
        self._opt_stack = stacked_adam_init(
            self.params, len(self.clients), host=self._store == "host") \
            if self.persistent_opt else None
        # the quantized uplink's per-client fp32 error-feedback rows,
        # reset here, at the prune, where the leaf shapes change
        self._err_stack = stacked_zeros(
            self.params, len(self.clients), dtype=torch.float32,
            host=self._store == "host") if self.quant != "none" else None
        if self._obs_compile is not None:
            # a re-watch grants one more check with growth: the
            # compacted model's new shapes after the prune are expected
            self._obs_compile.watch_host_caches()

    def _stored_copies(self) -> int:
        """fp32 model copies this trainer keeps on the card across
        rounds, for the engine's chunk size: the persistent Adam rows and
        the error-feedback rows of the N clients (when on the card), and
        the edges' late-delta sums."""
        rows = 0 if self._store == "host" else len(self.clients) * (
            2 * self.persistent_opt + (self.quant != "none"))
        return rows + self.fl.num_edges * (self.aggregation == "staleness")

    # -- bookkeeping ----------------------------------------------------------
    def _param_count_m(self) -> float:
        return sum(t.numel() for t in tree_leaves(self.params)) / 1e6

    def _wire_bytes(self):
        """Bytes a transfer: ``(up, up_late, down)``, the on-time uplink
        (quantized: payload and scales), the fp32 uplink of late clients
        and of the edges, and the compute-dtype download."""
        return (uplink_bytes(self.params, self.quant),
                uplink_bytes(self.params, "none"),
                downlink_bytes(self.params, self.cfg.precision))

    def late_buffers(self) -> Dict[int, dict]:
        """The buffered late-delta sums (staleness), edge -> tree."""
        return dict(self._late_buf)

    # -- local training + edge aggregation (Alg. 1 lines 7-21) ---------------
    def _use_vectorized(self, round_clients) -> bool:
        use, self._warned_ragged = route_engine(
            self.engine, self._engine_strict, round_clients,
            self._warned_ragged)
        return use

    def _opt_rows(self, idx):
        """The persistent Adam rows of clients ``idx``, on the device."""
        return store_tree(tree_gather(self._opt_stack, idx), "device",
                          self.device)

    def _err_rows(self, idx):
        """The error-feedback rows of clients ``idx``, on the device."""
        return store_tree(tree_gather(self._err_stack, idx), "device",
                          self.device)

    def _local_and_edge_sequential(self, r, assignment, sparse_round, wire,
                                   faults=None):
        """One client after another, one step a batch; Python
        aggregation per edge.  Under ``faults`` a client runs its budget
        of steps (its shuffles still drain), only reporting clients
        enter the edge's aggregate and send, and late clients' deltas are
        buffered for the edge's next aggregate.  With ``quant`` each
        on-time reporter's delta makes the error-feedback round trip and
        the edge aggregates ``start + deq``; late deltas stay fp32."""
        fl = self.fl
        up_q, up_f, down = wire
        step_fn = self.step_sparse if sparse_round else self.step_plain
        round_losses: List[float] = []
        loss_mask: List[bool] = []
        up_bytes, down_bytes = 0.0, 0.0
        for e, cids in assignment.items():
            if not cids:
                continue
            edge_model = self.params if self._edge_models is None \
                else self._edge_models.get(e, self.params)
            client_models, counts, mus = [], [], []
            late_models, late_counts = [], []
            n_arrived = 0
            for cid in cids:
                cl = self.clients[cid]
                budget = faults.budget_of(cid) if faults else None
                opt_in = self._opt_rows(int(cid)) if self.persistent_opt \
                    else self._opt_zero
                p, opt_out, loss = run_local(step_fn, edge_model, cl,
                                             epochs=fl.local_epochs,
                                             generator=self.gen,
                                             opt_state=opt_in,
                                             max_steps=budget,
                                             step_seconds=self.step_seconds)
                completed = faults is None or faults.completed_of(cid)
                late = faults is not None and faults.late_of(cid)
                if self.persistent_opt and completed:
                    self._opt_stack = tree_scatter(self._opt_stack,
                                                   int(cid), opt_out)
                round_losses.append(loss)
                loss_mask.append(budget is None or budget > 0)
                if faults is not None and faults.arrived_of(cid):
                    n_arrived += 1
                if completed:
                    self.edges[e].update(cl.q_n, cl.n_samples)  # Eq. 19
                    up_bytes += self.comm.client_edge(up_f if late
                                                      else up_q)  # upload
                if late:
                    late_models.append(p)
                    late_counts.append(cl.n_samples)
                elif completed:                       # on time
                    if self.quant != "none":      # start + deq
                        p, new_err = ef_roundtrip(
                            p, self._err_rows(int(cid)), self.quant,
                            start=edge_model)
                        self._err_stack = tree_scatter(self._err_stack,
                                                       int(cid), new_err)
                    client_models.append(p)
                    counts.append(cl.n_samples)
                    mus.append(sh_score(cl.q_n, self.q_u))
            if r % fl.edge_agg_every == 0:
                if not client_models:
                    agg = edge_model          # no reporter: keep the model
                elif self.aggregation == "sh":
                    agg = aggregate_sh(client_models, counts, mus,
                                       fl.sh_a, fl.sh_b)        # Eq. 23/24
                else:
                    agg = aggregate_fedavg(client_models, counts)
                if self.aggregation == "staleness":
                    agg = merge_late(agg, self._late_buf.pop(e, None),
                                     self.fault)
                    if late_models:
                        self._late_buf[e] = late_delta(
                            late_models, edge_model,
                            late_shares(counts, late_counts))
                if self._edge_models is None:
                    self._edge_models = {}
                self._edge_models[e] = agg
                n_down = len(cids) if faults is None else n_arrived
                down_bytes += self.comm.client_edge(down) * n_down
        return round_losses, up_bytes, down_bytes, loss_mask

    def _local_and_edge_vectorized(self, r, assignment, sparse_round, wire,
                                   faults=None):
        """All the round's clients in one client-batched step a batch
        (:mod:`repro_torch.fl.engine`), the edges aggregated by one fused
        (E, C) contraction, the losses synced once.  Under ``faults`` the
        budgets truncate the (C, S) valid mask by a prefix, clients that
        do not report get zero aggregation weight (the reporters'
        renormalized), and late deltas come back through ``w_late``."""
        fl = self.fl
        obs = self._obs
        up_q, up_f, down = wire
        with obs.span("round/host_prep", round=r):
            order = [(e, cid) for e, cids in assignment.items()
                     for cid in cids]
            clients = [self.clients[cid] for _, cid in order]
            # the clients' shuffles in edge-iteration order, as the
            # sequential loop draws them
            batches, valid = stack_round([cl.data for cl in clients],
                                         fl.local_epochs)
            cid_of = np.asarray([cid for _, cid in order])
            if faults is not None:
                valid = faults.truncate(valid, cid_of)
        self._t_local = time.perf_counter()
        with obs.span("round/h2d", round=r):
            batches = {k: host_to_device(v, self.device)
                       for k, v in batches.items()}
            # the DDPM draws, client after client, in the sequential order
            draws = draw_round(self.gen, valid, batches["images"].shape[2:],
                               self.cfg.diffusion_steps, self.device)
            edge_models = self._edge_models or {}
            edge_stack = stack_trees([edge_models.get(e, self.params)
                                      for e in range(fl.num_edges)])
        edge_idx = np.asarray([e for e, _ in order])
        reporting = np.asarray([faults is None or faults.reporting_of(cid)
                                for cid in cid_of], bool)
        completed = np.asarray([faults is None or faults.completed_of(cid)
                                for cid in cid_of], bool)
        late = np.asarray([faults is not None and faults.late_of(cid)
                           for cid in cid_of], bool)
        n = np.asarray([self.clients[cid].n_samples for cid in cid_of])

        def weights(rep):
            """An edge's Eq. 23/24 weights on its reporters ``rep``."""
            if self.aggregation != "sh":
                return fedavg_weights(n[rep])
            return sh_weights(n[rep], [sh_score(self.clients[c].q_n,
                                                self.q_u)
                                       for c in cid_of[rep]],
                              fl.sh_a, fl.sh_b)
        w_mat, w_late = edge_weight_rows(edge_idx, fl.num_edges, n,
                                         reporting, late, weights)
        engine = self._engine_sparse if sparse_round else self._engine_plain
        with obs.span("round/dispatch", round=r):
            out = engine(edge_stack, edge_idx, batches, valid, draws, w_mat,
                         opt_states=self._opt_rows(cid_of)
                         if self.persistent_opt else None, w_late=w_late,
                         err=self._err_rows(cid_of)
                         if self.quant != "none" else None)
        if self.persistent_opt:
            # only completed clients keep their moments
            scatter_rows(self._opt_stack, cid_of, out["opt"], completed)
        if self.quant != "none":
            # only on-time reporters sent a quantized payload
            scatter_rows(self._err_stack, cid_of, out["err"], reporting)

        up_bytes, down_bytes = 0.0, 0.0
        for (e, cid), done, lt in zip(order, completed, late):
            if done:
                cl = self.clients[cid]
                self.edges[e].update(cl.q_n, cl.n_samples)      # Eq. 19
                up_bytes += self.comm.client_edge(up_f if lt
                                                  else up_q)   # upload
        if r % fl.edge_agg_every == 0:
            with obs.span("round/edge_agg", round=r):
                if self._edge_models is None:
                    self._edge_models = {}
                for e, cids in assignment.items():
                    if not cids:
                        continue
                    if w_mat[e].any():
                        agg = tree_map(lambda leaf, _e=e: leaf[_e],
                                       out["agg"])
                    else:                     # no reporter: keep the model
                        agg = edge_models.get(e, self.params)
                    if self.aggregation == "staleness":
                        agg = merge_late(agg, self._late_buf.pop(e, None),
                                         self.fault)
                        if w_late is not None and w_late[e].any():
                            self._late_buf[e] = tree_map(
                                lambda leaf, _e=e: leaf[_e], out["late"])
                    self._edge_models[e] = agg
                    n_down = len(cids) if faults is None else sum(
                        faults.arrived_of(cid) for cid in cids)
                    down_bytes += self.comm.client_edge(down) * n_down
        loss_mask = [faults is None or faults.budget_of(cid) > 0
                     for cid in cid_of]
        # no sync: the (C,) losses stay on the device until _finish_round
        return out["losses"], up_bytes, down_bytes, loss_mask

    # -- one communication round (Alg. 1 lines 3-32) -------------------------
    def run_round(self, r: int) -> RoundRecord:
        return self._finish_round(self._start_round(r))

    def _start_round(self, r: int) -> Dict:
        """Selection, local training, edge and cloud aggregation and (at
        r >= R_s) pruning: everything but the wait for the device's
        losses.  Returns the pending round ``_finish_round`` records.  On
        the vectorized engine nothing here syncs outside the prune round
        (a host store syncs for its rows), so ``run()`` dispatches round
        r+1 while round r is still on the device."""
        fl = self.fl
        C = max(1, round(fl.participation * len(self.clients)))
        if self._faults is not None:
            # the churn first (its own stream), then the participants
            # from the online clients only: with churn 0 the selection
            # stream draws as without faults
            pool = np.flatnonzero(self._faults.begin_round())
            C = min(C, len(pool))
            sel_ids = pool[self.np_rng.choice(len(pool), size=C,
                                              replace=False)]
        else:
            sel_ids = self.np_rng.choice(len(self.clients), size=C,
                                         replace=False)
        # lines 4-5: clients select edge servers
        assignment: Dict[int, List[int]] = {e: [] for e in
                                            range(fl.num_edges)}
        for cid in sel_ids:
            cl = self.clients[cid]
            if self.selection == "sh":
                e = select_edge(self.np_rng, self.edges, cl.q_n,
                                cl.n_samples, a=fl.sh_a, b=fl.sh_b)
            else:
                e = random_selection(self.np_rng, fl.num_edges)
            assignment[e].append(int(cid))

        sparse_round = (self.prune and not self.pruned
                        and fl.prune_mode == "group_norm"
                        and r < fl.sparse_rounds)
        faults = None
        if self._faults is not None:
            steps = [fl.local_epochs * self.clients[c].data.steps_per_epoch
                     for c in sel_ids]
            faults = self._faults.draw_round(
                sel_ids, steps, self.aggregation == "staleness")
            if self._obs.enabled:
                self._obs.event("fault/draw", round=r, **faults.summary())
        wire = self._wire_bytes()
        self._t_local = None
        if self._use_vectorized([self.clients[c] for c in sel_ids]):
            round_losses, up_bytes, down_bytes, loss_mask = \
                self._local_and_edge_vectorized(r, assignment, sparse_round,
                                                wire, faults)
        else:
            # the sequential loop syncs every step: host prep, compute
            # and aggregation interleave, so it gets one dispatch span
            with self._obs.span("round/dispatch", round=r):
                round_losses, up_bytes, down_bytes, loss_mask = \
                    self._local_and_edge_sequential(
                        r, assignment, sparse_round, wire, faults)

        pruned_this_round = False
        # lines 23-31: cloud aggregation every r_g rounds
        if r % fl.cloud_agg_every == 0 and self._edge_models is not None:
            with self._obs.span("round/cloud_agg", round=r):
                models, counts, mus = [], [], []
                # the edges send fp32 (only the client uplink is quantized)
                for e, m in self._edge_models.items():
                    models.append(m)
                    counts.append(self.edges[e].n)
                    mus.append(self.edges[e].sh(self.q_u))      # Eq. 20
                    up_bytes += self.comm.edge_cloud(wire[1])   # upload
                if self.aggregation == "sh":
                    self.params = aggregate_sh(models, counts, mus, fl.sh_a,
                                               fl.sh_b)         # Eq. 21/22
                else:
                    self.params = aggregate_fedavg(models, counts)
                # lines 26-28: structured pruning at r = R_s
                if (self.prune and not self.pruned
                        and fl.prune_mode == "group_norm"
                        and r >= fl.sparse_rounds):
                    with self._obs.span("round/prune", round=r):
                        self._prune_now(mode="group_norm")
                        self._rebuild_steps()
                    pruned_this_round = True
                    wire = self._wire_bytes()
                    # buffered late deltas have the old shapes
                    self._late_buf = {}
                # broadcast and refresh (lines 29-31)
                down_bytes += self.comm.edge_cloud(wire[2]) * fl.num_edges
                self._edge_models = {e: self.params
                                     for e in range(fl.num_edges)}
                for edge in self.edges:
                    edge.refresh()

        # what the record and the eval hook read, taken now: a round
        # dispatched before this one is finished must not leak into it
        return {"round": r, "losses": round_losses,
                "t_local": self._t_local,
                "up_bytes": up_bytes, "down_bytes": down_bytes,
                "sel_ids": sel_ids, "pruned": pruned_this_round,
                "params": self.params, "cfg": self.cfg,
                "params_m": self._param_count_m(),
                "edge_sh": [e.sh(self.q_u) for e in self.edges],
                "loss_mask": loss_mask,
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
            edge_sh=pend["edge_sh"],
            pruned=pend["pruned"],
            availability=pend["availability"])
        # appended before the eval hook: the round ran and the streams
        # advanced, so a raising eval_fn loses the eval, not the round
        self.history.append(rec)
        if self._obs_compile is not None:
            # what this round's dispatch built is in the caches by now
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
        ``fl.rounds``; after ``restore`` the run continues).
        ``eval_every`` replaces the trainer's cadence.  The rounds are
        double-buffered (:func:`run_pipelined`)."""
        rounds = rounds or self.fl.rounds
        if eval_every is not None:
            self.eval_every = eval_every
        run_pipelined(self, rounds)
        return RunResult(self.history, evals_of(self.history))

    # -- checkpoint state (the experiment API's resume contract) -------------
    def state(self):
        """``(arrays, meta)``: a tree for ``repro_torch.checkpoint.save``
        and JSON-serializable metadata, in the reference's keys
        (``repro/core/hfl.py:state``).  ``rng`` is the key
        ``jax.random.PRNGKey(rng_seed)`` holds, so the reference loads
        the file; the model-noise stream itself is the generator's
        state, ``torch_rng`` (read by the port only)."""
        arrays = {
            "params": self.params,
            "rng": prng_key(self.rng_seed),
            "opt_stack": self._opt_stack,
            "edge_models": None if self._edge_models is None else
            {str(e): m for e, m in self._edge_models.items()},
            "edge_counts": np.stack([e.counts for e in self.edges]),
            "edge_n": np.asarray([e.n for e in self.edges], np.int64),
            "late_buf": {str(e): t for e, t in self._late_buf.items()}
            or None,
            # the uplink's error-feedback rows: a resumed run is bitwise
            # the unbroken one only with them
            "err_stack": self._err_stack,
            "torch_rng": self.gen.get_state().numpy(),
        }
        meta = {
            "trainer": "fedphd",
            "pruned": bool(self.pruned),
            "cfg": config_to_dict(self.cfg),
            "np_rng": self.np_rng.bit_generator.state,
            "client_rngs": [cl.data.rng_state() for cl in self.clients],
            "history": [rec.to_dict() for rec in self.history],
            "fault": self._faults.state() if self._faults else None,
            "torch_rng_device": self.gen.device.type,
        }
        return arrays, meta

    def restore(self, arrays, meta) -> None:
        """Inverse of ``state()`` on a trainer built with the same
        arguments (config, FL config, clients, seed).  A checkpoint of
        the reference has no generator state: the generator stays as
        construction left it, with a warning.  A generator state saved
        on another device type raises."""
        saved = meta.get("torch_rng_device")
        if saved is not None and saved != self.gen.device.type:
            raise RuntimeError(
                f"the checkpoint's generator state is a {saved!r} "
                f"generator's and this trainer's is "
                f"{self.gen.device.type!r}: the two draw different "
                f"streams; resume on a {saved!r} device")
        cfg = config_from_dict(meta["cfg"])
        self.cfg = cfg.replace(precision=resolve_precision(cfg.precision))
        self.pruned = bool(meta["pruned"])
        self.params = params_from_jax(arrays["params"], self.device)
        self.groups = build_groups(self.cfg, self.params)
        self._edge_models = None if arrays.get("edge_models") is None else \
            {int(e): params_from_jax(m, self.device)
             for e, m in arrays["edge_models"].items()}
        for i, e in enumerate(self.edges):
            e.counts = np.asarray(arrays["edge_counts"][i],
                                  np.float64).copy()
            e.n = int(arrays["edge_n"][i])
        self._late_buf = {int(e): params_from_jax(t, self.device)
                          for e, t in (arrays.get("late_buf") or {}).items()}
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
        self._rebuild_steps()
        if self.persistent_opt:
            self._opt_stack = adam_stack_from_tree(
                arrays["opt_stack"], self._store, self.device)
        if self.quant != "none" and arrays.get("err_stack") is not None:
            # after _rebuild_steps, which zeroed them for the restored
            # shapes
            self._err_stack = store_tree(arrays["err_stack"], self._store,
                                         self.device)
