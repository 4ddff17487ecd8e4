"""Pruning masks from scores, and the kept indices compaction takes
(``repro/core/pruning/masks.py``).

Kept channel counts are rounded to multiples of 8 (128 once a group is
at least 1024 wide); head/expert units are not rounded.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.core.pruning.groups import PruneGroup


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
    """Top-k-by-score 0/1 float32 masks per group.  Ranks come from a
    stable argsort, so ties break by index and exactly k units survive."""
    masks = {}
    for g in groups:
        s = scores[g.name]
        idx = torch.argsort(-s, dim=-1, stable=True)
        rank = torch.argsort(idx, dim=-1, stable=True)
        masks[g.name] = (rank < kept_count(g, ratio)).float()
    return masks


def keep_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Sorted indices of the kept units of a (size,) mask."""
    idx = torch.argsort(-mask, dim=-1, stable=True)[..., :k]
    return torch.sort(idx, dim=-1).values
