"""Statistical homogeneity (SH) score and the edges' accumulated label
distributions (``repro/core/sh_score.py``; paper §IV-B, Eqs. 18-20).

mu = 2 - ||q - q_u||_2 measures how close a label distribution q is to
the uniform target q_u.  An edge accumulates the distributions of the
clients that reported to it since the last cloud refresh (Eq. 19).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def uniform_target(num_classes: int) -> np.ndarray:
    return np.full((num_classes,), 1.0 / num_classes, np.float64)


def sh_score(q: np.ndarray, q_u: Optional[np.ndarray] = None) -> float:
    """Eq. 18 / Eq. 20: mu = 2 - sqrt(sum_y |q(y) - q_u(y)|^2)."""
    q = np.asarray(q, np.float64)
    if q_u is None:
        q_u = uniform_target(q.shape[-1])
    return float(2.0 - np.sqrt(np.sum(np.square(q - q_u))))


def label_distribution(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Empirical label distribution q_n(y) of a client dataset."""
    counts = np.bincount(np.asarray(labels, np.int64), minlength=num_classes)
    total = max(counts.sum(), 1)
    return counts.astype(np.float64) / total


class AccumulatedDistribution:
    """An edge's running distribution q_e(y) with sample count n_e.

    Eq. 19: q_e' = (q_e n_e + sum_n q_n n_n) / (n_e + sum_n n_n);
    ``refresh()`` starts over at every cloud aggregation (Alg. 1 line 31).
    """

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.counts = np.zeros((num_classes,), np.float64)
        self.n = 0

    def update(self, q_n: np.ndarray, n_n: int) -> None:
        self.counts += np.asarray(q_n, np.float64) * n_n
        self.n += int(n_n)

    @property
    def q(self) -> np.ndarray:
        if self.n == 0:
            return uniform_target(self.num_classes)
        return self.counts / self.n

    def sh(self, q_u: Optional[np.ndarray] = None) -> float:
        return sh_score(self.q, q_u)

    def peek_with(self, q_n: np.ndarray, n_n: int):
        """(n_e', mu_e') if client (q_n, n_n) were added (Eq. 25)."""
        counts = self.counts + np.asarray(q_n, np.float64) * n_n
        n = self.n + int(n_n)
        return n, sh_score(counts / max(n, 1))

    def refresh(self) -> None:
        self.counts[:] = 0.0
        self.n = 0
