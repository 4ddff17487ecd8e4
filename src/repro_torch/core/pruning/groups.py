"""Declared dependency groups for structured pruning
(``repro/core/pruning/groups.py``).

A ``PruneGroup`` names a set of units (channels, heads, experts,
recurrence lanes) and the parameter slices each unit owns, the groups
that leave the residual stream untouched.  The U-Net's: every
ResBlock's internal channels (conv1-out, temb-out, norm2, conv2-in) and
every attention block's per-channel q/k/v/proj slices.  A transformer's,
layer by layer: attention KV heads (each with its G = q_per_kv query
heads), whisper's cross-attention heads, FFN channels, RG-LRU lanes,
MoE experts and shared-FFN channels, RWKV time-mix heads and
channel-mix channels; MLA's latent attention is left whole.  A group
over scan-stacked cycle parameters carries ``stacked = n_cycles`` and
one layer index per cycle (the depth-aware lambda_g, Eq. 17).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      RWKV, ModelConfig)

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
# transformer groups
# ---------------------------------------------------------------------------
def _attn_head_group(prefix: Path, cfg: ModelConfig, has_bias: bool,
                     key: str = "attn") -> List[GroupMember]:
    """KV head k owns its K/V columns and its G query heads' Q columns
    and WO rows (and their biases)."""
    hd, G = cfg.head_dim, cfg.q_per_kv
    m = [GroupMember(prefix + (key, "wq"), axis=1, chunk=G * hd),
         GroupMember(prefix + (key, "wk"), axis=1, chunk=hd),
         GroupMember(prefix + (key, "wv"), axis=1, chunk=hd),
         GroupMember(prefix + (key, "wo"), axis=0, chunk=G * hd)]
    if has_bias:
        m += [GroupMember(prefix + (key, "bq"), axis=0, chunk=G * hd),
              GroupMember(prefix + (key, "bk"), axis=0, chunk=hd),
              GroupMember(prefix + (key, "bv"), axis=0, chunk=hd)]
    return m


def _ffn_group(prefix: Path, glu: bool, bias: bool) -> List[GroupMember]:
    m = [GroupMember(prefix + ("ffn", "w_in"), axis=1),
         GroupMember(prefix + ("ffn", "w_out"), axis=0)]
    if glu:
        m.append(GroupMember(prefix + ("ffn", "w_gate"), axis=1))
    if bias:
        m.append(GroupMember(prefix + ("ffn", "b_in"), axis=0))
    return m


def _layer_groups(prefix: Path, lp: Dict, kind: int, cfg: ModelConfig, *,
                  stacked: int, layers: Tuple[int, ...],
                  tag: str) -> List[PruneGroup]:
    """One layer's groups (one pattern position's, over its stacked
    cycles, when ``stacked``), named ``tag/<kind of unit>``."""
    groups: List[PruneGroup] = []

    def add(name, size, members, unit):
        groups.append(PruneGroup(name=f"{tag}/{name}", size=size,
                                 members=tuple(members), stacked=stacked,
                                 layer_indices=layers, unit=unit))

    if kind in (ATTN_GLOBAL, ATTN_LOCAL):
        if "attn" in lp:        # an MLA layer's latent attention stays whole
            add("heads", cfg.num_kv_heads,
                _attn_head_group(prefix, cfg, "bq" in lp["attn"]), "head")
        if "cross" in lp:
            add("cross_heads", cfg.num_kv_heads,
                _attn_head_group(prefix, cfg, "bq" in lp["cross"],
                                 key="cross"), "head")
        if "moe" in lp:
            moe = cfg.moe
            add("experts", moe.num_experts, [
                GroupMember(prefix + ("moe", "router"), axis=1),
                GroupMember(prefix + ("moe", "w_gate"), axis=0),
                GroupMember(prefix + ("moe", "w_in"), axis=0),
                GroupMember(prefix + ("moe", "w_out"), axis=0),
            ], "expert")
            if "shared" in lp["moe"]:
                add("shared_ffn", moe.d_shared, [
                    GroupMember(prefix + ("moe", "shared", "w_in"), axis=1),
                    GroupMember(prefix + ("moe", "shared", "w_gate"),
                                axis=1),
                    GroupMember(prefix + ("moe", "shared", "w_out"), axis=0),
                ], "channel")
        elif "ffn" in lp:
            add("ffn", cfg.d_ff, _ffn_group(prefix, cfg.glu,
                                            cfg.use_ffn_bias), "channel")
    elif kind == RECURRENT:
        # a lane owns both axes of the (W, W) gate matrices
        add("lru", cfg.lru_width, [
            GroupMember(prefix + ("rec", "w_x"), axis=1),
            GroupMember(prefix + ("rec", "w_y"), axis=1),
            GroupMember(prefix + ("rec", "conv_w"), axis=1),
            GroupMember(prefix + ("rec", "conv_b"), axis=0),
            GroupMember(prefix + ("rec", "w_a"), axis=0),
            GroupMember(prefix + ("rec", "w_a"), axis=1),
            GroupMember(prefix + ("rec", "b_a"), axis=0),
            GroupMember(prefix + ("rec", "w_i"), axis=0),
            GroupMember(prefix + ("rec", "w_i"), axis=1),
            GroupMember(prefix + ("rec", "b_i"), axis=0),
            GroupMember(prefix + ("rec", "log_lambda"), axis=0),
            GroupMember(prefix + ("rec", "w_out"), axis=0),
        ], "lane")
        if "ffn" in lp:
            add("ffn", cfg.d_ff, _ffn_group(prefix, cfg.glu,
                                            cfg.use_ffn_bias), "channel")
    elif kind == RWKV:
        hd = cfg.head_dim
        add("tmix_heads", cfg.num_heads, [
            GroupMember(prefix + ("tmix", "w_r"), axis=1, chunk=hd),
            GroupMember(prefix + ("tmix", "w_k"), axis=1, chunk=hd),
            GroupMember(prefix + ("tmix", "w_v"), axis=1, chunk=hd),
            GroupMember(prefix + ("tmix", "w_g"), axis=1, chunk=hd),
            GroupMember(prefix + ("tmix", "w_o"), axis=0, chunk=hd),
            GroupMember(prefix + ("tmix", "u"), axis=0),
            GroupMember(prefix + ("tmix", "ln_scale"), axis=0, chunk=hd),
            GroupMember(prefix + ("tmix", "decay_b"), axis=1, chunk=hd),
            GroupMember(prefix + ("tmix", "w0"), axis=0, chunk=hd),
        ], "head")
        add("cmix_ffn", cfg.d_ff, [
            GroupMember(prefix + ("cmix", "w_k"), axis=1),
            GroupMember(prefix + ("cmix", "w_v"), axis=0),
        ], "channel")
    return groups


def transformer_groups(cfg: ModelConfig, params: Dict) -> List[PruneGroup]:
    """The head layers' groups, each pattern position's over its stacked
    cycles, the tail layers', and an encdec model's encoder blocks'
    (stacked, their depth indexed on its own)."""
    from repro_torch.models.transformer import stack_plan
    plan = stack_plan(cfg)
    plen = len(plan.pattern)
    groups: List[PruneGroup] = []
    for i, lp in enumerate(params["head"]):
        groups += _layer_groups(("head", i), lp, plan.pattern[0], cfg,
                                stacked=0, layers=(i,), tag=f"head{i}")
    for pos in range(plen):
        lp = params["cycles"][pos]
        if lp is None:
            continue
        layers = tuple(plan.n_head + c * plen + pos
                       for c in range(plan.n_cycles))
        groups += _layer_groups(("cycles", pos), lp, plan.pattern[pos], cfg,
                                stacked=plan.n_cycles, layers=layers,
                                tag=f"cyc{pos}")
    base = plan.n_head + plan.n_cycles * plen
    for i, kind in enumerate(plan.tail_kinds):
        groups += _layer_groups(("tail", i), params["tail"][i], kind, cfg,
                                stacked=0, layers=(base + i,),
                                tag=f"tail{i}")
    if cfg.arch_type == "encdec":
        ne = cfg.num_encoder_layers
        groups += _layer_groups(("encoder", "blocks"),
                                params["encoder"]["blocks"], ATTN_GLOBAL,
                                cfg, stacked=ne, layers=tuple(range(ne)),
                                tag="enc")
    return groups


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


def build_groups(cfg: ModelConfig, params: Dict) -> List[PruneGroup]:
    """Every prunable group of a model: :func:`unet_groups` for a U-Net,
    :func:`transformer_groups` for every other config."""
    if cfg.arch_type == "unet":
        return unet_groups(cfg, params)
    return transformer_groups(cfg, params)
