"""Group-lasso sparse-training regularizer (``repro/core/pruning/
regularizer.py``; paper Eqs. 16-17).

Omega(G, k) = sum_g lambda_g * sum_k ||theta^g[k]||_2^2 with the
depth-aware scale lambda_g = lambda_0 / Q(theta^g), Q = |l - l_mid|:
the U-Net's middle layers, the most redundant, get the largest pressure.
The inner sums of squares of every group come from one launch of the
differentiable segmented group sum-of-squares kernel
(:func:`repro_torch.core.pruning.criteria.unit_sq_norms`), and Omega is
their dot product with each unit's lambda_g.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pruning.criteria import unit_sq_norms
from repro_torch.core.pruning.groups import PruneGroup


def depth_lambdas(groups: List[PruneGroup],
                  lambda0: float) -> Dict[str, np.ndarray]:
    """lambda_g per group, as float32 arrays (one entry per layer)."""
    max_layer = max((max(g.layer_indices) for g in groups
                     if g.layer_indices), default=0)
    l_mid = max_layer / 2.0
    out = {}
    for g in groups:
        q = np.abs(np.asarray(g.layer_indices, np.float32) - l_mid)
        q = np.maximum(q, 0.5)          # no divide-by-zero at the middle
        out[g.name] = (lambda0 / q).astype(np.float32)
    return out


@functools.lru_cache(maxsize=16)
def _unit_lambdas(lams: Tuple[float, ...], sizes: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """lambda_g repeated over group g's units, on ``device`` once."""
    return torch.from_numpy(np.repeat(np.asarray(lams, np.float32),
                                      sizes)).to(device)


def omega(params, groups: List[PruneGroup],
          lambdas: Dict[str, np.ndarray],
          clients: Optional[int] = None) -> torch.Tensor:
    """The term a sparse round adds to the local loss (fp32 scalar).
    ``clients=C``: stacked params, each client's Omega from one launch,
    (C,)."""
    sq = unit_sq_norms(params, groups, clients)
    lam = _unit_lambdas(tuple(float(lambdas[g.name][0]) for g in groups),
                        tuple(g.size for g in groups), sq.device)
    if clients is None:
        return torch.dot(lam, sq)
    return torch.mv(sq.view(clients, -1), lam)
