"""Client -> edge selection (``repro/core/selection.py``; paper Eq. 25).

P_n(e) is proportional to ReLU(a mu_e' - n_e' + b), with mu_e' and n_e'
the edge's SH score and sample count after hypothetically adding client
n: prefer the edge that becomes most homogeneous, penalize loaded ones.
Both draws take the caller's numpy generator, as the reference's do.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.sh_score import AccumulatedDistribution


def selection_probabilities(edges: Sequence[AccumulatedDistribution],
                            q_n: np.ndarray, n_n: int, *, a: float,
                            b: float) -> np.ndarray:
    raw = np.zeros(len(edges), np.float64)
    for i, e in enumerate(edges):
        n_after, mu_after = e.peek_with(q_n, n_n)
        raw[i] = max(a * mu_after - n_after + b, 0.0)
    total = raw.sum()
    if total <= 0:
        return np.full(len(edges), 1.0 / len(edges))
    return raw / total


def select_edge(rng: np.random.Generator,
                edges: Sequence[AccumulatedDistribution], q_n: np.ndarray,
                n_n: int, *, a: float, b: float) -> int:
    p = selection_probabilities(edges, q_n, n_n, a=a, b=b)
    return int(rng.choice(len(edges), p=p))


def random_selection(rng: np.random.Generator, num_edges: int) -> int:
    """The baseline of the paper's Fig. 7/8 comparison."""
    return int(rng.integers(num_edges))
