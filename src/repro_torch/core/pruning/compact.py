"""Physical compaction (``repro/core/pruning/compact.py``): slice the
pruned units out of every group's parameters, once, at the cloud at
r = R_s (Alg. 1 line 26).  Training then continues on genuinely smaller
tensors: 72 and 144 channels where the dense U-Net has 128 and 256.

A scan-stacked group gathers each cycle's own kept units (its mask has
a row a cycle, each with the same count), as the reference's ``vmap``
take does; the config then shrinks to the groups' uniform kept counts
(heads, FFN channels, RG-LRU lanes, RWKV heads, experts), which keeps
the stacked layers shape-compatible.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning.groups import PruneGroup, get_path, set_path
from repro_torch.core.pruning.masks import keep_indices


def _unit_flat_indices(keep_idx: torch.Tensor, chunk: int,
                       offset: int) -> torch.Tensor:
    """(..., k) unit indices -> (..., k*chunk) element indices."""
    base = keep_idx * chunk + offset
    return (base[..., :, None]
            + torch.arange(chunk, device=base.device)).reshape(
        keep_idx.shape[:-1] + (-1,))


def _take(param: torch.Tensor, axis: int, flat: torch.Tensor,
          stacked: bool) -> torch.Tensor:
    """``param``'s elements at ``flat`` along ``axis``; a stacked param
    takes each cycle's own row of ``flat``, written into one new tensor
    (no list of cycles beside it)."""
    if not stacked:
        return param.index_select(axis, flat)
    shape = list(param.shape)
    shape[axis] = flat.shape[-1]
    out = param.new_empty(shape)
    for c in range(param.shape[0]):
        torch.index_select(param[c], axis - 1, flat[c], out=out[c])
    return out


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
        pieces.append(_take(param, axis, _unit_flat_indices(
            keep_idx, m.chunk, m.offset), bool(g.stacked)))
        cursor = m.offset + g.size * m.chunk
    if cursor < dim:
        pieces.append(param.narrow(axis, cursor, dim - cursor))
    return torch.cat(pieces, dim=axis) if len(pieces) > 1 else pieces[0]


def compact_params(params, groups: List[PruneGroup],
                   masks: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict[str, int]]:
    """Slice the kept units out of every group.  Returns (params,
    kept counts); a stacked group's count is its first cycle's (every
    row of a ``make_masks`` mask keeps the same number)."""
    kept: Dict[str, int] = {}
    for g in groups:
        mask = torch.as_tensor(masks[g.name])
        k = int((mask[0] if g.stacked else mask).sum())
        kept[g.name] = k
        keep_idx = keep_indices(mask, k)
        # members sharing a (path, axis) rebuild that parameter once
        by_pa = defaultdict(list)
        for m in g.members:
            by_pa[(m.path, m.axis + (1 if g.stacked else 0))].append(m)
        for (path, axis), members in by_pa.items():
            p = get_path(params, path)
            new_p = _compact_param_axis(p, axis, members, g,
                                        keep_idx.to(p.device))
            params = set_path(params, path, new_p)
    return params, kept


def _uniform(groups: List[PruneGroup], kept: Dict[str, int],
             suffix: str) -> int:
    """The one kept count of the groups named ``*suffix``, 0 if none."""
    vals = {kept[g.name] for g in groups if g.name.endswith(suffix)}
    if not vals:
        return 0
    if len(vals) != 1:
        raise ValueError(f"non-uniform kept counts for {suffix}: {vals}")
    return vals.pop()


def compact_config(cfg: ModelConfig, groups: List[PruneGroup],
                   kept: Dict[str, int]) -> ModelConfig:
    """The post-compaction config.  A U-Net's internal channel counts
    live in its parameter shapes, so its config does not change; a
    transformer's heads (KV heads, each with its q_per_kv query heads),
    d_ff, lru_width, RWKV heads and MoE experts and shared width take
    the groups' kept counts, and its name gains ``-pruned``."""
    if cfg.arch_type == "unet":
        return cfg
    changes = {}
    k_heads = _uniform(groups, kept, "/heads")
    if k_heads:
        changes["num_kv_heads"] = k_heads
        changes["num_heads"] = k_heads * cfg.q_per_kv
    k_ffn = _uniform(groups, kept, "/ffn") or _uniform(groups, kept,
                                                       "/cmix_ffn")
    if k_ffn:
        changes["d_ff"] = k_ffn
    k_lru = _uniform(groups, kept, "/lru")
    if k_lru:
        changes["lru_width"] = k_lru
    k_tmix = _uniform(groups, kept, "/tmix_heads")
    if k_tmix:
        changes["num_heads"] = k_tmix
        changes["num_kv_heads"] = k_tmix
    if cfg.moe is not None:
        moe_changes = {}
        k_exp = _uniform(groups, kept, "/experts")
        if k_exp:
            moe_changes["num_experts"] = k_exp
            moe_changes["experts_per_token"] = min(
                cfg.moe.experts_per_token, k_exp)
        k_shared = _uniform(groups, kept, "/shared_ffn")
        if k_shared:
            moe_changes["d_shared"] = k_shared
        if moe_changes:
            changes["moe"] = dataclasses.replace(cfg.moe, **moe_changes)
    return cfg.replace(name=cfg.name + "-pruned", **changes) if changes \
        else cfg


def compact(params, cfg: ModelConfig, groups: List[PruneGroup],
            masks: Dict[str, torch.Tensor]):
    """(params, cfg, masks) -> (new params, new cfg, report), the report
    mapping each group to (kept, size)."""
    new_params, kept = compact_params(params, groups, masks)
    new_cfg = compact_config(cfg, groups, kept)
    report = {g.name: (kept[g.name], g.size) for g in groups}
    return new_params, new_cfg, report
