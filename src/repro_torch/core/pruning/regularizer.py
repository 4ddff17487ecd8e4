"""Group-lasso sparse-training regularizer (``repro/core/pruning/
regularizer.py``; paper Eqs. 16-17).

Omega(G, k) = sum_g lambda_g * sum_k ||theta^g[k]||_2^2 with the
depth-aware scale lambda_g = lambda_0 / Q(theta^g), Q = |l - l_mid|:
the U-Net's middle layers, the most redundant, get the largest pressure.
The inner sums of squares run through the differentiable group
sum-of-squares kernel (:func:`repro_torch.models.ops.group_sq_norms_2d`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.pruning.criteria import group_sq_norms
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


def omega(params, groups: List[PruneGroup],
          lambdas: Dict[str, np.ndarray]) -> torch.Tensor:
    """The term a sparse round adds to the local loss (fp32 scalar)."""
    total = None
    for g in groups:
        # lambda is float32 already: the product rounds as the reference's
        term = float(lambdas[g.name][0]) * torch.sum(group_sq_norms(params, g))
        total = term if total is None else total + term
    return total
