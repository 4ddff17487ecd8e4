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

Not ported yet: meshes, fault injection and staleness, quantized
uplinks, tracing, the eval hook and checkpoint state.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.aggregation import (aggregate_fedavg, aggregate_sh,
                                          fedavg_weights, normalize_weights,
                                          sh_weights)
from repro_torch.core.pruning import (compact, l2_scores, make_masks,
                                      random_scores, unet_groups)
from repro_torch.core.selection import random_selection, select_edge
from repro_torch.core.sh_score import (AccumulatedDistribution, sh_score,
                                       uniform_target)
from repro_torch.data.pipeline import stack_round
from repro_torch.device import resolve_device
from repro_torch.experiment.resolve import resolve_engine, resolve_precision
from repro_torch.fl.client import Client, make_local_step, run_local
from repro_torch.fl.comm import CommModel
from repro_torch.fl.engine import (draw_round, make_round_engine,
                                   resolve_store, route_engine,
                                   stack_trees, stacked_adam_init,
                                   store_tree, tree_gather, tree_scatter)
from repro_torch.fl.compress import downlink_bytes, uplink_bytes
from repro_torch.fl.record import RoundRecord, RunResult
from repro_torch.models import model
from repro_torch.optim import adam_init
from repro_torch.tree import tree_leaves, tree_map

SELECTIONS = ("sh", "random")
AGGREGATIONS = ("sh", "fedavg")


class FedPhD:
    """The FedPhD trainer.

    selection: "sh" (Eq. 25) or "random"; aggregation: "sh" (Eqs.
    21-24) or "fedavg".  ``prune=False`` trains the dense model
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
    """

    def __init__(self, cfg: ModelConfig, fl: FLConfig, clients: List[Client],
                 *, rng_seed: int = 0, selection: str = "sh",
                 aggregation: str = "sh", prune: bool = True,
                 lr: float = 2e-4, engine: Optional[str] = None,
                 persistent_opt: bool = False, state_store: str = "auto",
                 device="cuda"):
        if selection not in SELECTIONS:
            raise ValueError(f"selection {selection!r} not in {SELECTIONS}")
        if aggregation not in AGGREGATIONS:
            raise ValueError(f"aggregation {aggregation!r} not in "
                             f"{AGGREGATIONS}")
        self.device = resolve_device(device)
        self.cfg = cfg.replace(precision=resolve_precision(cfg.precision))
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
        self.np_rng = np.random.default_rng(rng_seed)
        self.gen = torch.Generator(self.device)
        self.gen.manual_seed(rng_seed)

        num_classes = clients[0].num_classes
        self.q_u = uniform_target(num_classes)
        self.edges = [AccumulatedDistribution(num_classes)
                      for _ in range(fl.num_edges)]
        self.params = model.init(self.cfg, self.gen, device=self.device)
        self.groups = unet_groups(self.cfg, self.params)
        self.comm = CommModel()
        self.history: List[RoundRecord] = []
        self.pruned = False
        self.prune_report: Optional[Dict[str, tuple]] = None
        # edge id -> the edge's model; None until the first edge aggregation
        self._edge_models: Optional[Dict[int, dict]] = None
        # host seconds of every sequential local step, each ending in its
        # loss sync, and of every vectorized round's local training, from
        # the batches' upload to the round's loss sync
        self.step_seconds: List[float] = []
        self.round_seconds: List[float] = []

        if prune and fl.prune_mode.startswith("oneshot"):
            self._prune_now(mode=fl.prune_mode)
        self._rebuild_steps()

    # -- pruning ------------------------------------------------------------
    def _prune_now(self, mode: str) -> None:
        if mode == "oneshot_random":
            scores = random_scores(self.gen, self.groups, device=self.device)
        else:                                 # group_norm or oneshot_l2
            scores = l2_scores(self.params, self.groups)
        masks = make_masks(scores, self.groups, self.fl.prune_ratio)
        self.params, self.cfg, self.prune_report = compact(
            self.params, self.cfg, self.groups, masks)
        self.groups = unet_groups(self.cfg, self.params)
        self.pruned = True

    def _rebuild_steps(self) -> None:
        sparse = (self.prune and not self.pruned
                  and self.fl.prune_mode == "group_norm")
        self.step_sparse = make_local_step(
            self.cfg, self.fl, sparse=True, groups=self.groups,
            lr=self.lr) if sparse else None
        self.step_plain = make_local_step(self.cfg, self.fl, sparse=False,
                                          lr=self.lr)
        self._engine_sparse = make_round_engine(
            self.cfg, self.fl, sparse=True, groups=self.groups,
            lr=self.lr) if sparse else None
        self._engine_plain = make_round_engine(self.cfg, self.fl,
                                               sparse=False, lr=self.lr)
        # one Adam zero-state per model shape, shared by every client of
        # the sequential engine
        self._opt_zero = adam_init(self.params)
        # persistent per-client moments: a stacked (N, ...) state both
        # engines gather and scatter by participation, reset (rebuilt as
        # zeros) whenever pruning changes the parameter shapes
        self._opt_stack = stacked_adam_init(
            self.params, len(self.clients), host=self._store == "host") \
            if self.persistent_opt else None

    # -- bookkeeping ----------------------------------------------------------
    def _param_count_m(self) -> float:
        return sum(t.numel() for t in tree_leaves(self.params)) / 1e6

    def _wire_bytes(self):
        """(fp32 upload, compute-dtype download) bytes per transfer."""
        return (uplink_bytes(self.params),
                downlink_bytes(self.params, self.cfg.precision))

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

    def _local_and_edge_sequential(self, r, assignment, sparse_round, wire):
        """One client after another, one step a batch; Python
        aggregation per edge."""
        fl = self.fl
        up, down = wire
        step_fn = self.step_sparse if sparse_round else self.step_plain
        round_losses: List[float] = []
        up_bytes, down_bytes = 0.0, 0.0
        for e, cids in assignment.items():
            if not cids:
                continue
            edge_model = self.params if self._edge_models is None \
                else self._edge_models.get(e, self.params)
            client_models, counts, mus = [], [], []
            for cid in cids:
                cl = self.clients[cid]
                opt_in = self._opt_rows(int(cid)) if self.persistent_opt \
                    else self._opt_zero
                p, opt_out, loss = run_local(step_fn, edge_model, cl,
                                             epochs=fl.local_epochs,
                                             generator=self.gen,
                                             opt_state=opt_in,
                                             step_seconds=self.step_seconds)
                if self.persistent_opt:
                    self._opt_stack = tree_scatter(self._opt_stack,
                                                   int(cid), opt_out)
                round_losses.append(loss)
                self.edges[e].update(cl.q_n, cl.n_samples)      # Eq. 19
                up_bytes += self.comm.client_edge(up)          # upload
                client_models.append(p)
                counts.append(cl.n_samples)
                mus.append(sh_score(cl.q_n, self.q_u))
            if r % fl.edge_agg_every == 0:
                if self.aggregation == "sh":
                    agg = aggregate_sh(client_models, counts, mus,
                                       fl.sh_a, fl.sh_b)        # Eq. 23/24
                else:
                    agg = aggregate_fedavg(client_models, counts)
                if self._edge_models is None:
                    self._edge_models = {}
                self._edge_models[e] = agg
                down_bytes += self.comm.client_edge(down) * len(cids)
        return round_losses, up_bytes, down_bytes

    def _local_and_edge_vectorized(self, r, assignment, sparse_round, wire):
        """All the round's clients in one client-batched step a batch
        (:mod:`repro_torch.fl.engine`), the edges aggregated by one fused
        (E, C) contraction, the losses synced once."""
        fl = self.fl
        up, down = wire
        order = [(e, cid) for e, cids in assignment.items() for cid in cids]
        clients = [self.clients[cid] for _, cid in order]
        # the clients' shuffles in edge-iteration order, as the
        # sequential loop draws them
        batches, valid = stack_round([cl.data for cl in clients],
                                     fl.local_epochs)
        t0 = time.perf_counter()
        batches = {k: torch.as_tensor(v, device=self.device)
                   for k, v in batches.items()}
        # the DDPM draws, client after client, in the sequential order
        draws = draw_round(self.gen, valid, batches["images"].shape[2:],
                           self.cfg.diffusion_steps, self.device)
        edge_models = self._edge_models or {}
        edge_stack = stack_trees([edge_models.get(e, self.params)
                                  for e in range(fl.num_edges)])
        edge_idx = np.asarray([e for e, _ in order])
        # W[e] = edge e's normalized Eq. 23/24 weights on its clients
        w_mat = np.zeros((fl.num_edges, len(order)), np.float32)
        for e, cids in assignment.items():
            if not cids:
                continue
            counts = [self.clients[cid].n_samples for cid in cids]
            mus = [sh_score(self.clients[cid].q_n, self.q_u) for cid in cids]
            w = sh_weights(counts, mus, fl.sh_a, fl.sh_b) \
                if self.aggregation == "sh" else fedavg_weights(counts)
            w_mat[e, edge_idx == e] = normalize_weights(w)
        engine = self._engine_sparse if sparse_round else self._engine_plain
        idx = np.asarray([cid for _, cid in order])
        out = engine(edge_stack, edge_idx, batches, valid, draws, w_mat,
                     opt_states=self._opt_rows(idx)
                     if self.persistent_opt else None)
        self.round_seconds.append(time.perf_counter() - t0)
        if self.persistent_opt:
            self._opt_stack = tree_scatter(self._opt_stack, idx, out["opt"])

        up_bytes, down_bytes = 0.0, 0.0
        for e, cid in order:
            cl = self.clients[cid]
            self.edges[e].update(cl.q_n, cl.n_samples)          # Eq. 19
            up_bytes += self.comm.client_edge(up)              # upload
        if r % fl.edge_agg_every == 0:
            if self._edge_models is None:
                self._edge_models = {}
            for e, cids in assignment.items():
                if not cids:
                    continue
                self._edge_models[e] = tree_map(lambda leaf, _e=e: leaf[_e],
                                                out["agg"])
                down_bytes += self.comm.client_edge(down) * len(cids)
        return list(out["losses"]), up_bytes, down_bytes

    # -- one communication round (Alg. 1 lines 3-32) -------------------------
    def run_round(self, r: int) -> RoundRecord:
        return self._finish_round(self._start_round(r))

    def _start_round(self, r: int) -> Dict:
        """Selection, local training, edge and cloud aggregation and (at
        r >= R_s) pruning; returns what ``_finish_round`` records."""
        fl = self.fl
        C = max(1, round(fl.participation * len(self.clients)))
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
        wire = self._wire_bytes()
        local = self._local_and_edge_vectorized \
            if self._use_vectorized([self.clients[c] for c in sel_ids]) \
            else self._local_and_edge_sequential
        round_losses, up_bytes, down_bytes = local(r, assignment,
                                                   sparse_round, wire)

        pruned_this_round = False
        # lines 23-31: cloud aggregation every r_g rounds
        if r % fl.cloud_agg_every == 0 and self._edge_models is not None:
            models, counts, mus = [], [], []
            for e, m in self._edge_models.items():
                models.append(m)
                counts.append(self.edges[e].n)
                mus.append(self.edges[e].sh(self.q_u))          # Eq. 20
                up_bytes += self.comm.edge_cloud(wire[0])       # upload
            if self.aggregation == "sh":
                self.params = aggregate_sh(models, counts, mus,
                                           fl.sh_a, fl.sh_b)    # Eq. 21/22
            else:
                self.params = aggregate_fedavg(models, counts)
            # lines 26-28: structured pruning at r = R_s
            if (self.prune and not self.pruned
                    and fl.prune_mode == "group_norm"
                    and r >= fl.sparse_rounds):
                self._prune_now(mode="group_norm")
                self._rebuild_steps()
                pruned_this_round = True
                wire = self._wire_bytes()
            # broadcast and refresh (lines 29-31)
            down_bytes += self.comm.edge_cloud(wire[1]) * fl.num_edges
            self._edge_models = {e: self.params
                                 for e in range(fl.num_edges)}
            for edge in self.edges:
                edge.refresh()

        return {"round": r, "losses": round_losses,
                "up_bytes": up_bytes, "down_bytes": down_bytes,
                "sel_ids": sel_ids, "pruned": pruned_this_round,
                "params_m": self._param_count_m(),
                "edge_sh": [e.sh(self.q_u) for e in self.edges]}

    def _finish_round(self, pend: Dict) -> RoundRecord:
        losses = pend["losses"]
        rec = RoundRecord(
            round=pend["round"],
            loss=float(np.mean(losses)) if losses else float("nan"),
            comm_gb=pend["up_bytes"] / 1e9 + pend["down_bytes"] / 1e9,
            comm_up_gb=pend["up_bytes"] / 1e9,
            comm_down_gb=pend["down_bytes"] / 1e9,
            params_m=pend["params_m"],
            selected=[int(c) for c in pend["sel_ids"]],
            edge_sh=pend["edge_sh"],
            pruned=pend["pruned"])
        self.history.append(rec)
        return rec

    def run(self, rounds: Optional[int] = None) -> RunResult:
        """Run rounds ``len(history)+1 .. rounds`` (default
        ``fl.rounds``)."""
        rounds = rounds or self.fl.rounds
        for r in range(len(self.history) + 1, rounds + 1):
            self.run_round(r)
        return RunResult(self.history, [])
