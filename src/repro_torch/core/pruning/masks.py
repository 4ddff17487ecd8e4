"""Pruning masks from scores, the kept indices compaction takes, and
the masks applied as zeroed weights (``repro/core/pruning/masks.py``).

Kept channel counts are rounded to multiples of 8 (128 once a group is
at least 1024 wide); head/expert units are not rounded.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.pruning.groups import PruneGroup, get_path, set_path


def alignment_for(g: PruneGroup) -> int:
    if g.unit in ("head", "expert"):
        return 1
    if g.size >= 1024 and g.size % 128 == 0:
        return 128
    if g.size >= 16 and g.size % 8 == 0:
        return 8
    return 1


def kept_count(g: PruneGroup, ratio: float) -> int:
    align = alignment_for(g)
    keep = max(1, round(g.size * (1.0 - ratio)))
    if align > 1:
        keep = max(align, round(keep / align) * align)
    return min(keep, g.size)


def make_masks(scores: Dict[str, torch.Tensor], groups: List[PruneGroup],
               ratio: float) -> Dict[str, torch.Tensor]:
    """Top-k-by-score 0/1 float32 masks per group (per cycle, one row
    each, for a stacked group).  Ranks come from a stable argsort, so
    ties break by index and exactly k units of a row survive."""
    masks = {}
    for g in groups:
        s = scores[g.name]
        idx = torch.argsort(-s, dim=-1, stable=True)
        rank = torch.argsort(idx, dim=-1, stable=True)
        masks[g.name] = (rank < kept_count(g, ratio)).float()
    return masks


def keep_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted indices of the kept units: a (..., size) mask -> (..., k)."""
    idx = torch.argsort(-mask, dim=-1, stable=True)[..., :k]
    return torch.sort(idx, dim=-1).values


def _mask_vector(mask_row: torch.Tensor, m, dim: int) -> torch.Tensor:
    """A (size,) mask as a (dim,) multiplier for one member's axis: each
    unit's chunk at the member's offset, ones elsewhere."""
    full = torch.ones((dim,), dtype=torch.float32, device=mask_row.device)
    rep = torch.repeat_interleave(mask_row.float(), m.chunk)
    full[m.offset:m.offset + rep.shape[0]] = rep
    return full


def apply_masks(params, groups: List[PruneGroup],
                masks: Dict[str, torch.Tensor]):
    """Zero the pruned units' slices (the shape-stable sparse-training
    form): a new tree, ``params`` unchanged."""
    for g in groups:
        mask = torch.as_tensor(masks[g.name])
        for m in g.members:
            p = get_path(params, m.path)
            axis = m.axis + (1 if g.stacked else 0)
            dim = p.shape[axis]
            shape = [1] * p.dim()
            shape[axis] = dim
            if g.stacked:
                vec = torch.stack([_mask_vector(row.to(p.device), m, dim)
                                   for row in mask])
                shape[0] = mask.shape[0]
            else:
                vec = _mask_vector(mask.to(p.device), m, dim)
            params = set_path(params, m.path,
                              p * vec.reshape(shape).to(p.dtype))
    return params


def sparsity_report(groups: List[PruneGroup],
                    masks: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """Group name -> (kept units, size); a stacked group reports its
    first cycle."""
    out = {}
    for g in groups:
        m = torch.as_tensor(masks[g.name])
        out[g.name] = (int(torch.sum(m[0] if g.stacked else m)), g.size)
    return out
