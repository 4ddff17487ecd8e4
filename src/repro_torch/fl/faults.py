"""Seeded client availability and fault injection (``repro/fl/faults.py``).

FedPhD targets unreliable clients: devices that never show up for a
round, crash mid-round, compute at half speed, or leave the population.

  :class:`FaultSpec`   the knobs, frozen and JSON-round-trippable (on
                       ``ExperimentSpec.fault``);
  :class:`FaultModel`  their seeded realization: one numpy Generator of
                       its own (independent of the selection stream)
                       draws each round's churn, arrivals, dropouts,
                       straggler budgets;
  :class:`RoundFaults` one round's schedule, read by both engines.

Every round draws a fixed count of variates (one churn vector, three
uniform vectors over the selection) whatever is active, so the schedule
is the same on both engines, across a kill and resume (the Generator's
state checkpoints) and across aggregation modes.  The host stream is
the reference's, draw for draw: selections, budgets and availability
records match it bitwise.

Faults act on local training as data: a client's step budget truncates
the vectorized engine's (C, S) valid mask by a prefix, or caps
``run_local`` on the sequential engine, whose shuffles still drain.

Staleness (``aggregation="staleness"``): a straggler that misses the
deadline trains to completion and reports one round late.  Its weighted
delta ``sum_j w_j (theta_j - start)``, ``w_j = n_j / sum(all reporting
and late n)``, is buffered and merged into the next aggregate as
``base + gamma * delta`` (:func:`apply_late`); with no stragglers the
mode is FedAvg.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.aggregation import (normalize_weights,
                                          weighted_average_stacked)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """The fault model, all probabilities per round.

    arrival:        P(a selected client shows up at all).
    dropout:        P(an arrived client crashes mid-round): it runs a
                    uniform prefix of its step budget and uploads nothing.
    straggler_frac: the share of the population that runs slow.
    slowdown:       the slow clients' compute-time multiplier (>= 1).
    deadline:       the round's deadline in units of the nominal local
                    round: a client finishes ``floor(steps * deadline /
                    speed)`` of its steps by it.
    churn:          P(a client's membership flips between rounds);
                    offline clients cannot be selected.
    staleness:      gamma in [0, 1], the weight of late deltas where they
                    merge (read only under ``aggregation="staleness"``).
    seed:           the fault stream's seed, combined with the
                    experiment's.
    """
    arrival: float = 1.0
    dropout: float = 0.0
    straggler_frac: float = 0.0
    slowdown: float = 2.0
    deadline: float = 1.0
    churn: float = 0.0
    staleness: float = 0.5
    seed: int = 0

    def __post_init__(self):
        for name in ("arrival", "dropout", "straggler_frac", "churn",
                     "staleness"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault.{name}={v} not in [0, 1]")
        if self.slowdown < 1.0:
            raise ValueError(f"fault.slowdown={self.slowdown} < 1")
        if not 0.0 < self.deadline <= 1.0:
            raise ValueError(f"fault.deadline={self.deadline} not in (0, 1]")

    @property
    def enabled(self) -> bool:
        """True iff any fault can fire.  A disabled spec is ``fault=None``
        to the trainers, bit for bit."""
        return (self.arrival < 1.0 or self.dropout > 0.0
                or self.churn > 0.0 or self.deadline < 1.0
                or (self.straggler_frac > 0.0 and self.slowdown > 1.0))

    def replace(self, **kw) -> "FaultSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class RoundFaults:
    """One round's schedule, each array aligned with ``sel_ids``.
    ``budget`` is each client's local steps; ``reporting`` clients enter
    this round's aggregation; ``completed`` adds the late ones (they
    finished and report next round), and only completed clients update
    their client-local state (persistent Adam, the method's rows)."""
    sel_ids: np.ndarray
    arrived: np.ndarray
    dropped: np.ndarray
    late: np.ndarray
    budget: np.ndarray
    n_online: int

    def __post_init__(self):
        self._pos: Dict[int, int] = {int(c): i
                                     for i, c in enumerate(self.sel_ids)}

    @property
    def completed(self) -> np.ndarray:
        return self.arrived & ~self.dropped

    @property
    def reporting(self) -> np.ndarray:
        return self.completed & ~self.late

    def arrived_of(self, cid: int) -> bool:
        return bool(self.arrived[self._pos[int(cid)]])

    def completed_of(self, cid: int) -> bool:
        return bool(self.completed[self._pos[int(cid)]])

    def reporting_of(self, cid: int) -> bool:
        return bool(self.reporting[self._pos[int(cid)]])

    def late_of(self, cid: int) -> bool:
        return bool(self.late[self._pos[int(cid)]])

    def budget_of(self, cid: int) -> int:
        return int(self.budget[self._pos[int(cid)]])

    def truncate(self, valid: np.ndarray, cids) -> np.ndarray:
        """The (C, S) valid mask of clients ``cids`` with client i's
        steps past its budget masked: it runs only its first budget_i
        steps."""
        budgets = np.asarray([self.budget_of(c) for c in cids])
        return valid & (np.arange(valid.shape[1])[None, :]
                        < budgets[:, None])

    def availability(self) -> dict:
        """``RoundRecord.availability``: the record both engines, and a
        resumed run, must give bit for bit."""
        ids = self.sel_ids
        return {
            "online": int(self.n_online),
            "arrived": [int(c) for c in ids[self.arrived]],
            "dropped": [int(c) for c in ids[self.dropped]],
            "late": [int(c) for c in ids[self.late]],
            "budgets": [int(b) for b in self.budget],
        }

    def summary(self) -> dict:
        """The round's counts."""
        return {
            "online": int(self.n_online),
            "selected": int(len(self.sel_ids)),
            "arrived": int(self.arrived.sum()),
            "completed": int(self.completed.sum()),
            "dropped": int(self.dropped.sum()),
            "late": int(self.late.sum()),
        }


class FaultModel:
    """A :class:`FaultSpec` realized over ``num_clients`` clients, on a
    numpy stream seeded ``[base_seed, spec.seed]`` whose state
    checkpoints with the trainer."""

    def __init__(self, spec: FaultSpec, num_clients: int, base_seed: int):
        self.spec = spec
        self.num_clients = num_clients
        self.rng = np.random.default_rng([base_seed, spec.seed])
        # speed is a property of the population, drawn once: a
        # straggler_frac share of the clients run `slowdown` x slower
        n_slow = int(round(spec.straggler_frac * num_clients))
        perm = self.rng.permutation(num_clients)
        self.speed = np.ones(num_clients, np.float64)
        self.speed[perm[:n_slow]] = spec.slowdown
        self.online = np.ones(num_clients, bool)

    def begin_round(self) -> np.ndarray:
        """Advance the churn and return the online mask the round's
        selection draws from.  Draws one (N,) uniform vector whatever
        ``churn`` is."""
        flips = self.rng.random(self.num_clients) < self.spec.churn
        self.online ^= flips
        if not self.online.any():
            # an empty population cannot run a round: one client comes
            # back, drawn from the stream
            self.online[int(self.rng.integers(self.num_clients))] = True
        return self.online.copy()

    def draw_round(self, sel_ids, steps: Sequence[int],
                   staleness_mode: bool) -> RoundFaults:
        """The round's schedule over the selected clients, from three
        (C,) uniform vectors whatever is active.  ``steps`` is each
        client's nominal step count; ``staleness_mode`` sends a client
        that misses the deadline on to a late full run instead of
        truncating it."""
        sel_ids = np.asarray(sel_ids)
        steps = np.asarray(steps, np.int64)
        u_arrive = self.rng.random(len(sel_ids))
        u_drop = self.rng.random(len(sel_ids))
        u_prefix = self.rng.random(len(sel_ids))
        spec = self.spec

        arrived = u_arrive < spec.arrival
        dropped = arrived & (u_drop < spec.dropout)
        # the deadline as a step budget: a `speed` x slower client
        # finishes steps * deadline / speed of its steps in time
        cap = np.minimum(steps, np.floor(
            steps * spec.deadline / self.speed[sel_ids]).astype(np.int64))
        late = (arrived & ~dropped & (cap < steps)) if staleness_mode \
            else np.zeros(len(sel_ids), bool)
        budget = np.where(late, steps, cap)
        # a dropped client crashes at a uniform prefix of its budget
        budget = np.where(dropped,
                          np.floor(u_prefix * cap).astype(np.int64), budget)
        budget = np.where(arrived, budget, 0)
        return RoundFaults(sel_ids=sel_ids, arrived=arrived, dropped=dropped,
                           late=late, budget=budget,
                           n_online=int(self.online.sum()))

    def state(self) -> dict:
        """JSON-serializable state (``speed`` is redrawn at construction:
        the permutation is the stream's first draw)."""
        return {"rng": self.rng.bit_generator.state,
                "online": [bool(b) for b in self.online]}

    def set_state(self, st: dict) -> None:
        self.rng.bit_generator.state = st["rng"]
        self.online = np.asarray(st["online"], bool).copy()


def make_fault_model(fault: Optional[FaultSpec], num_clients: int,
                     base_seed: int) -> Optional[FaultModel]:
    """None for a missing or disabled spec, so that every fault branch of
    the trainers falls back to the fault-free path exactly."""
    if fault is None or not fault.enabled:
        return None
    return FaultModel(fault, num_clients, base_seed)


# ---------------------------------------------------------------------------
# staleness aggregation, on both engines and topologies
# ---------------------------------------------------------------------------

def apply_late(base, delta, gamma: float):
    """``base + gamma * delta`` in fp32, cast back to the base's dtypes."""
    return tree_map(lambda b, d: (b.float() + gamma * d.float()).to(b.dtype),
                    base, delta)


def late_delta(models: List, base, weights: Sequence[float]):
    """``sum_j w_j (theta_j - base)`` in fp32, the weights as given: the
    late clients' share of the round's sample mass, not renormalized.
    The sequential form of the engine's ``w_late`` contraction."""
    deltas = [tree_map(lambda a, b: a.float() - b.float(), m, base)
              for m in models]
    stacked = tree_map(lambda *ls: torch.stack(ls), *deltas)
    return weighted_average_stacked(stacked, np.asarray(weights, np.float32))


def late_shares(rep_counts, late_counts) -> np.ndarray:
    """The late clients' weights ``n_j / (sum of the reporting and late
    n)``, one an entry of ``late_counts``."""
    tot = max(int(np.sum(rep_counts)) + int(np.sum(late_counts)), 1)
    return np.asarray(late_counts, np.float64) / tot


def merge_late(agg, buf, fault: Optional[FaultSpec]):
    """``agg`` with a buffered late-delta sum merged at the spec's
    staleness weight; ``agg`` itself when nothing is buffered."""
    if buf is None:
        return agg
    return apply_late(agg, buf, fault.staleness if fault else 0.0)


def edge_weight_rows(edge_idx, num_edges: int, counts, reporting, late,
                     weights_fn):
    """The vectorized engine's ``(w_mat, w_late)``, (E, C) each, for C
    clients on the edges ``edge_idx`` with sample counts ``counts``:
    edge e's row of ``w_mat`` holds ``weights_fn``'s weights of its
    reporting clients (called with their mask), normalized, and zeros
    elsewhere; its row of ``w_late`` the :func:`late_shares` of its late
    clients.  ``w_late`` is None when no client is late."""
    counts = np.asarray(counts)
    w_mat = np.zeros((num_edges, len(counts)), np.float32)
    w_late = np.zeros_like(w_mat)
    for e in range(num_edges):
        rep = (edge_idx == e) & reporting
        lat = (edge_idx == e) & late
        if rep.any():
            w_mat[e, rep] = normalize_weights(weights_fn(rep))
        if lat.any():
            w_late[e, lat] = late_shares(counts[rep], counts[lat])
    return w_mat, (w_late if w_late.any() else None)
