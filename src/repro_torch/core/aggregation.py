"""Model aggregation (``repro/core/aggregation.py``): FedAvg weighting,
FedPhD's homogeneity-aware weighting (paper Eqs. 21-24) and the uniform
weights of SCAFFOLD's control-variate mean.

The weights are host numpy, uploaded without blocking the host; the
weighted sums run on the parameters' device, one stacked fp32
contraction per leaf, identical at the edge and the cloud tiers.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.tree import tree_leaves, tree_map


def normalize_weights(weights: Sequence[float]) -> np.ndarray:
    """A convex combination; uniform if the weights are degenerate."""
    w = np.asarray(weights, np.float64)
    total = w.sum()
    if total <= 0:
        return np.full_like(w, 1.0 / len(w))
    return w / total


def contract_leaf(stacked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The fp32 contraction of the leading member axis of one stacked
    leaf with ``w`` ((N,) or (G, N))."""
    eq = "gn,n...->g..." if w.dim() == 2 else "n,n...->..."
    return torch.einsum(eq, w.float(), stacked.float())


def cast_like(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An fp32 sum cast back to a leaf's dtype; integer leaves (an Adam
    step) are rounded, not truncated.  On a mesh the rounding comes
    after the sum over ranks, never on each rank's partial sum."""
    if not dtype.is_floating_point:
        return torch.round(acc).to(dtype)
    return acc.to(dtype)


def combine_leaf(stacked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract the leading member axis of one stacked leaf with ``w``
    ((N,) or (G, N)) in fp32, then cast back (:func:`cast_like`)."""
    return cast_like(contract_leaf(stacked, w), stacked.dtype)


def weighted_average_stacked(stacked_tree, weights):
    """sum_n w_n theta_n over the leading member axis of every leaf of a
    stacked tree; ``weights`` (N,) gives one tree, a (G, N) matrix of
    rows (the vectorized engine's (E, C) edge rows) G trees stacked on a
    leading axis.  The rows are used as given (callers normalize)."""
    w = host_to_device(np.asarray(weights, np.float32),
                       tree_leaves(stacked_tree)[0].device)
    return tree_map(lambda leaf: combine_leaf(leaf, w), stacked_tree)


def weighted_average(param_trees: Sequence, weights: Sequence[float]):
    """sum_i w_i theta_i with the weights normalized to 1."""
    w = normalize_weights(weights).astype(np.float32)
    wt = host_to_device(w, tree_leaves(param_trees[0])[0].device)
    return tree_map(lambda *leaves: combine_leaf(torch.stack(leaves), wt),
                    *param_trees)


def uniform_weights(n: int) -> np.ndarray:
    """Unnormalized equal weights; ``normalize_weights`` makes them
    exactly 1/n (SCAFFOLD's unweighted control-variate mean)."""
    return np.ones(n)


def fedavg_weights(sample_counts: Sequence[int]) -> np.ndarray:
    """rho_n = D_n / D (Eq. 10)."""
    n = np.asarray(sample_counts, np.float64)
    return n / max(n.sum(), 1.0)


def sh_weights(sample_counts: Sequence[int], sh_scores: Sequence[float],
               a: float, b: float) -> np.ndarray:
    """Eqs. 22/24: rho = ReLU(n + a mu + b) / sum ReLU(...)."""
    n = np.asarray(sample_counts, np.float64)
    mu = np.asarray(sh_scores, np.float64)
    raw = np.maximum(n + a * mu + b, 0.0)
    total = raw.sum()
    if total <= 0:                      # degenerate: FedAvg
        return fedavg_weights(sample_counts)
    return raw / total


def aggregate_fedavg(param_trees: Sequence, sample_counts: Sequence[int]):
    return weighted_average(param_trees, fedavg_weights(sample_counts))


def aggregate_sh(param_trees: Sequence, sample_counts: Sequence[int],
                 sh_scores: Sequence[float], a: float, b: float):
    """Homogeneity-aware aggregation (edge: Eq. 23/24; cloud: 21/22)."""
    return weighted_average(param_trees,
                            sh_weights(sample_counts, sh_scores, a, b))
