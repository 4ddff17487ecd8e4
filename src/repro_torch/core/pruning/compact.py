"""Physical compaction (``repro/core/pruning/compact.py``): slice the
pruned units out of every group's parameters, once, at the cloud at
r = R_s (Alg. 1 line 26).  Training then continues on genuinely smaller
tensors: 72 and 144 channels where the dense U-Net has 128 and 256.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning.groups import PruneGroup, get_path, set_path
from repro_torch.core.pruning.masks import keep_indices


def _unit_flat_indices(keep_idx: torch.Tensor, chunk: int,
                       offset: int) -> torch.Tensor:
    """(k,) unit indices -> (k*chunk,) element indices."""
    base = keep_idx * chunk + offset
    return (base[:, None] + torch.arange(chunk, device=base.device)[None, :]
            ).reshape(-1)


def _compact_param_axis(param: torch.Tensor, axis: int, members,
                        g: PruneGroup, keep_idx: torch.Tensor
                        ) -> torch.Tensor:
    """Rebuild one parameter along one axis from the kept units of the
    group's members on it (sorted by offset); regions no member owns
    are kept whole."""
    dim = param.shape[axis]
    pieces = []
    cursor = 0
    for m in sorted(members, key=lambda m: m.offset):
        if m.offset > cursor:
            pieces.append(param.narrow(axis, cursor, m.offset - cursor))
        pieces.append(param.index_select(
            axis, _unit_flat_indices(keep_idx, m.chunk, m.offset)))
        cursor = m.offset + g.size * m.chunk
    if cursor < dim:
        pieces.append(param.narrow(axis, cursor, dim - cursor))
    return torch.cat(pieces, dim=axis) if len(pieces) > 1 else pieces[0]


def compact_params(params, groups: List[PruneGroup],
                   masks: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict[str, int]]:
    """Slice the kept units out of every group.  Returns (params,
    kept counts)."""
    kept: Dict[str, int] = {}
    for g in groups:
        if g.stacked:
            raise ValueError(f"group {g.name!r} is scan-stacked; the "
                             f"port's U-Net groups never are")
        mask = masks[g.name]
        k = int(mask.sum())
        kept[g.name] = k
        keep_idx = keep_indices(mask, k)
        # members sharing a (path, axis) rebuild that parameter once
        by_pa = defaultdict(list)
        for m in g.members:
            by_pa[(m.path, m.axis)].append(m)
        for (path, axis), members in by_pa.items():
            new_p = _compact_param_axis(get_path(params, path), axis,
                                        members, g, keep_idx)
            params = set_path(params, path, new_p)
    return params, kept


def compact_config(cfg: ModelConfig, groups: List[PruneGroup],
                   kept: Dict[str, int]) -> ModelConfig:
    """The post-compaction config.  A U-Net's internal channel counts
    live in its parameter shapes, so its config does not change."""
    if cfg.arch_type == "unet":
        return cfg
    raise NotImplementedError(f"compacting a {cfg.arch_type!r} config "
                              f"waits for the transformer stack's port")


def compact(params, cfg: ModelConfig, groups: List[PruneGroup],
            masks: Dict[str, torch.Tensor]):
    """(params, cfg, masks) -> (new params, new cfg, report), the report
    mapping each group to (kept, size)."""
    new_params, kept = compact_params(params, groups, masks)
    new_cfg = compact_config(cfg, groups, kept)
    report = {g.name: (kept[g.name], g.size) for g in groups}
    return new_params, new_cfg, report
