"""The FedPhD trainer (``repro/core/hfl.py``; paper Algorithm 1),
sequential engine.

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

Not ported yet: the vectorized round engine, persistent client Adam
state, meshes, fault injection and staleness, quantized uplinks,
tracing, the eval hook and checkpoint state.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.aggregation import aggregate_fedavg, aggregate_sh
from repro_torch.core.pruning import (compact, l2_scores, make_masks,
                                      random_scores, unet_groups)
from repro_torch.core.selection import random_selection, select_edge
from repro_torch.core.sh_score import (AccumulatedDistribution, sh_score,
                                       uniform_target)
from repro_torch.device import resolve_device
from repro_torch.experiment.resolve import resolve_precision
from repro_torch.fl.client import Client, make_local_step, run_local
from repro_torch.fl.comm import CommModel
from repro_torch.fl.compress import downlink_bytes, uplink_bytes
from repro_torch.fl.record import RoundRecord, RunResult
from repro_torch.models import model
from repro_torch.optim import adam_init
from repro_torch.tree import tree_leaves

SELECTIONS = ("sh", "random")
AGGREGATIONS = ("sh", "fedavg")


class FedPhD:
    """The FedPhD trainer.

    selection: "sh" (Eq. 25) or "random"; aggregation: "sh" (Eqs.
    21-24) or "fedavg".  ``prune=False`` trains the dense model
    throughout.  ``device`` is where the model trains: ``"cuda"`` (the
    default; the kernels) or ``"cpu"`` (their plain versions).
    """

    def __init__(self, cfg: ModelConfig, fl: FLConfig, clients: List[Client],
                 *, rng_seed: int = 0, selection: str = "sh",
                 aggregation: str = "sh", prune: bool = True,
                 lr: float = 2e-4, device="cuda"):
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
        # host seconds of every local step, each ending in its loss sync
        self.step_seconds: List[float] = []

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
        # one Adam zero-state per model shape, shared by every client
        self._opt_zero = adam_init(self.params)

    # -- bookkeeping ----------------------------------------------------------
    def _param_count_m(self) -> float:
        return sum(t.numel() for t in tree_leaves(self.params)) / 1e6

    def _wire_bytes(self):
        """(fp32 upload, compute-dtype download) bytes per transfer."""
        return (uplink_bytes(self.params),
                downlink_bytes(self.params, self.cfg.precision))

    # -- local training + edge aggregation (Alg. 1 lines 7-21) ---------------
    def _local_and_edge_sequential(self, r, assignment, sparse_round, wire):
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
                p, _, loss = run_local(step_fn, edge_model, cl,
                                       epochs=fl.local_epochs,
                                       generator=self.gen,
                                       opt_state=self._opt_zero,
                                       step_seconds=self.step_seconds)
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
        round_losses, up_bytes, down_bytes = \
            self._local_and_edge_sequential(r, assignment, sparse_round,
                                            wire)

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
