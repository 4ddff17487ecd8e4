"""Pruning criteria (``repro/core/pruning/criteria.py``): L2 group norm
(paper §IV-A) and random (FedPhD-OS).

Each group member's owned span is sliced, its group axis moved last and
reshaped to ``(K, size*chunk)``: the layout the group sum-of-squares
kernel reduces (:func:`repro_torch.models.ops.group_sq_norms_2d`).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.pruning.groups import GroupMember, PruneGroup, get_path
from repro_torch.models import ops


def member_unit_sq(params, g: PruneGroup, m: GroupMember) -> torch.Tensor:
    """(size,) float32 sum of squares per unit for one member."""
    if g.stacked:
        raise ValueError(f"group {g.name!r} is scan-stacked; the port's "
                         f"U-Net groups never are")
    p = get_path(params, m.path)
    sl = p.narrow(m.axis, m.offset, g.size * m.chunk)
    w2d = torch.movedim(sl, m.axis, -1).reshape(-1, g.size * m.chunk)
    return ops.group_sq_norms_2d(w2d, g.size)


def group_sq_norms(params, g: PruneGroup) -> torch.Tensor:
    """||theta^g[k]||_2^2 per unit k (Eq. 17 inner term)."""
    out = None
    for m in g.members:
        s = member_unit_sq(params, g, m)
        out = s if out is None else out + s
    return out


def l2_scores(params, groups: List[PruneGroup]) -> Dict[str, torch.Tensor]:
    """Group-norm importance scores (sqrt of summed squares)."""
    return {g.name: torch.sqrt(group_sq_norms(params, g)) for g in groups}


def random_scores(generator: torch.Generator, groups: List[PruneGroup],
                  device="cuda") -> Dict[str, torch.Tensor]:
    """FedPhD-OS one-shot random scores (a torch stream: not the
    reference's jax.random draws)."""
    return {g.name: torch.rand((g.size,), generator=generator, device=device)
            for g in groups}
