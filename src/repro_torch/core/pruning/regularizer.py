"""Group-lasso sparse-training regularizer (``repro/core/pruning/
regularizer.py``; paper Eqs. 16-17).

Omega(G, k) = sum_g lambda_g * sum_k ||theta^g[k]||_2^2 with the
depth-aware scale lambda_g = lambda_0 / Q(theta^g), Q = |l - l_mid|:
the U-Net's middle layers, the most redundant, get the largest pressure.
The inner sums of squares of every unstacked group come from one launch
of the differentiable segmented group sum-of-squares kernel
(:func:`repro_torch.core.pruning.criteria.sq_norms`), and their
part of Omega is the dot product with each unit's lambda_g; a
scan-stacked group's come from plain ops, (stacked, size), each cycle
weighted by its own lambda_g and differentiated by autograd, as the
reference does.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pruning.criteria import sq_norms
from repro_torch.core.pruning.groups import PruneGroup


def depth_lambdas(groups: List[PruneGroup],
                  lambda0: float) -> Dict[str, np.ndarray]:
    """lambda_g per group, as float32 arrays (one entry per layer: per
    cycle for a stacked group)."""
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


@functools.lru_cache(maxsize=64)
def _cycle_lambdas(lams: Tuple[float, ...],
                   device: torch.device) -> torch.Tensor:
    """A stacked group's per-cycle lambda_g on ``device`` once."""
    return torch.tensor(lams, dtype=torch.float32, device=device)


def omega(params, groups: List[PruneGroup],
          lambdas: Dict[str, np.ndarray],
          clients: Optional[int] = None) -> torch.Tensor:
    """The term a sparse round adds to the local loss (fp32 scalar; 0
    for no groups, as the reference's).  ``clients=C``: stacked params,
    each client's Omega from one launch, (C,); no group may be
    scan-stacked then."""
    flat_sq, stacked = sq_norms(params, groups, clients)
    total = None
    if flat_sq is not None:
        flat = [g for g in groups if not g.stacked]
        lam = _unit_lambdas(tuple(float(lambdas[g.name][0]) for g in flat),
                            tuple(g.size for g in flat), flat_sq.device)
        total = torch.dot(lam, flat_sq) if clients is None \
            else torch.mv(flat_sq.view(clients, -1), lam)
    for name, sq in stacked.items():                  # (stacked, size)
        lam = _cycle_lambdas(tuple(float(x) for x in lambdas[name]),
                             sq.device)
        term = torch.sum(lam * torch.sum(sq, dim=-1))
        total = term if total is None else total + term
    if total is None:
        return torch.zeros(() if clients is None else (clients,))
    return total
