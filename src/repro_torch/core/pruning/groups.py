"""Declared dependency groups for structured pruning of the U-Net
(``repro/core/pruning/groups.py``).

A ``PruneGroup`` names a set of channel units and the parameter slices
each unit owns: every ResBlock's internal channels (conv1-out, temb-out,
norm2, conv2-in) and every attention block's per-channel q/k/v/proj
slices, the groups that leave the residual stream untouched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from repro_torch.configs.base import ModelConfig

Path = Tuple[Any, ...]


@dataclass(frozen=True)
class GroupMember:
    """One parameter slice owned by a group.

    Unit ``k`` owns indices ``[offset + k*chunk, offset + (k+1)*chunk)``
    along ``axis`` of the (unstacked) parameter at ``path``.
    """
    path: Path
    axis: int
    chunk: int = 1
    offset: int = 0


@dataclass(frozen=True)
class PruneGroup:
    name: str
    size: int                       # number of prunable units
    members: Tuple[GroupMember, ...]
    stacked: int = 0                # n_cycles if params are scan-stacked, else 0
    layer_indices: Tuple[int, ...] = ()   # per cycle (stacked) or single layer
    unit: str = "channel"           # channel | head | expert | lane


# ---------------------------------------------------------------------------
# pytree path utilities
# ---------------------------------------------------------------------------
def get_path(tree, path: Path):
    for p in path:
        tree = tree[p]
    return tree


def set_path(tree, path: Path, value):
    """Functional set: a new tree, dicts and lists copied along ``path``."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        new = dict(tree)
    elif isinstance(tree, list):
        new = list(tree)
    else:
        raise TypeError(f"cannot descend into {type(tree)}")
    new[head] = set_path(tree[head], rest, value)
    return new


# ---------------------------------------------------------------------------
# U-Net groups (paper's model): ResBlock internal channels + attention heads
# ---------------------------------------------------------------------------
def unet_groups(cfg: ModelConfig, params: Dict) -> List[PruneGroup]:
    groups: List[PruneGroup] = []
    layer_counter = [0]

    def resblock(prefix: Path, rp):
        lidx = layer_counter[0]
        layer_counter[0] += 1
        cout = rp["conv1"]["w"].shape[-1]
        groups.append(PruneGroup(
            name="/".join(map(str, prefix)), size=int(cout),
            members=(
                GroupMember(prefix + ("conv1", "w"), axis=3),
                GroupMember(prefix + ("conv1", "b"), axis=0),
                GroupMember(prefix + ("temb", "w"), axis=1),
                GroupMember(prefix + ("temb", "b"), axis=0),
                GroupMember(prefix + ("norm2", "scale"), axis=0),
                GroupMember(prefix + ("norm2", "bias"), axis=0),
                GroupMember(prefix + ("conv2", "w"), axis=2),
            ),
            layer_indices=(lidx,), unit="channel"))

    def attnblock(prefix: Path, ap):
        lidx = layer_counter[0]
        layer_counter[0] += 1
        c = ap["proj"]["w"].shape[2]
        groups.append(PruneGroup(
            name="/".join(map(str, prefix)), size=int(c),
            members=(
                GroupMember(prefix + ("qkv", "w"), axis=3, offset=0),
                GroupMember(prefix + ("qkv", "w"), axis=3, offset=c),
                GroupMember(prefix + ("qkv", "w"), axis=3, offset=2 * c),
                GroupMember(prefix + ("qkv", "b"), axis=0, offset=0),
                GroupMember(prefix + ("qkv", "b"), axis=0, offset=c),
                GroupMember(prefix + ("qkv", "b"), axis=0, offset=2 * c),
                GroupMember(prefix + ("proj", "w"), axis=2),
            ),
            layer_indices=(lidx,), unit="channel"))

    for side in ("down", "up"):
        for lvl, lvl_p in enumerate(params[side]):
            for b, blk in enumerate(lvl_p["blocks"]):
                resblock((side, lvl, "blocks", b, "res"), blk["res"])
                if "attn" in blk:
                    attnblock((side, lvl, "blocks", b, "attn"), blk["attn"])
        if side == "down":
            resblock(("mid", "res1"), params["mid"]["res1"])
            attnblock(("mid", "attn"), params["mid"]["attn"])
            resblock(("mid", "res2"), params["mid"]["res2"])
    return groups
