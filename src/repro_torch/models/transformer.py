"""Decoder stack (``repro/models/transformer.py``), the subset the
RecurrentGemma serving path runs: global and local attention layers and
RG-LRU recurrent layers, each with a dense FFN; full-sequence prefill
and single-token decode with per-kind caches (ring-buffer KV for
windowed attention, full KV for global attention, O(1) state for
RG-LRU).

Parameters are the reference's tree: ``head`` (unstacked leading
layers), ``cycles`` (one tree per position in the layer pattern, each
leaf stacked over the pattern's repetitions on its first axis) and
``tail`` (the pattern's remainder), so :mod:`repro_torch.convert`
carries weights across unchanged.  The reference scans the cycles with
``lax.scan``; here a Python loop walks the stacked leaves' first axis.

On a CUDA tensor the prefill's recurrences launch the scan kernel and
its attention the attention kernel (``models/ops.py:attention``, as the
reference's Pallas route); the dense projections are plain ``@``, as the
reference leaves them to XLA outside any kernel, and the decode step is
plain tensor ops, as the reference's is.  MoE, MLA, RWKV and
encoder-decoder or VLM models raise ``NotImplementedError`` (ROADMAP
A.13).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import ops
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       embed_init, rms_norm, softcap)
from repro_torch.models.ffn import apply_ffn, init_ffn
from repro_torch.tree import tree_map

Params = Dict[str, Any]
INT_MAX = torch.iinfo(torch.int32).max
_ATTN = (ATTN_GLOBAL, ATTN_LOCAL)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type != "decoder":
        raise NotImplementedError(f"{cfg.name!r} is {cfg.arch_type!r}; the "
                                  f"port's decoder stack runs decoder-only "
                                  f"LMs (ROADMAP A.13)")
    if cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name!r}: MoE and MLA layers are not "
                                  f"ported yet (ROADMAP A.13)")
    bad = set(cfg.layer_pattern) - {ATTN_GLOBAL, ATTN_LOCAL, RECURRENT}
    if bad:
        raise NotImplementedError(f"{cfg.name!r}: layer kinds {sorted(bad)} "
                                  f"(RWKV) are not ported yet (ROADMAP "
                                  f"A.13)")


# ===========================================================================
# Stack plan
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class StackPlan:
    """The reference's plan without its leading ``head`` layers, which
    only MoE models have (their trees keep an empty ``head`` list)."""
    n_cycles: int               # repetitions of the pattern
    pattern: Tuple[int, ...]
    tail_kinds: Tuple[int, ...]


def stack_plan(cfg: ModelConfig) -> StackPlan:
    _require_ported(cfg)
    plen = len(cfg.layer_pattern)
    return StackPlan(n_cycles=cfg.num_layers // plen,
                     pattern=cfg.layer_pattern,
                     tail_kinds=cfg.layer_pattern[: cfg.num_layers % plen])


def _stack(trees):
    """One tree whose leaves stack the trees' leaves on a new first axis."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _cycle(stacked, c: int):
    """Cycle ``c``'s tree out of a stacked one."""
    return tree_map(lambda t: t[c], stacked)


# ===========================================================================
# Init
# ===========================================================================
def init_attn_params(generator: torch.Generator, cfg: ModelConfig, dtype,
                     device="cpu") -> Params:
    d, hd = cfg.d_model, cfg.head_dim

    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    p = {"wq": dense(d, cfg.num_heads * hd),
         "wk": dense(d, cfg.num_kv_heads * hd),
         "wv": dense(d, cfg.num_kv_heads * hd),
         "wo": dense(cfg.num_heads * hd, d)}
    if cfg.use_qkv_bias:
        p["bq"] = zeros(cfg.num_heads * hd)
        p["bk"] = zeros(cfg.num_kv_heads * hd)
        p["bv"] = zeros(cfg.num_kv_heads * hd)
    if cfg.use_attn_out_bias:
        p["bo"] = zeros(d)
    return p


def init_layer(generator: torch.Generator, cfg: ModelConfig, kind: int, *,
               dtype=torch.float32, device="cpu") -> Params:
    d = cfg.d_model
    p: Params = {"ln1": torch.zeros((d,), dtype=dtype, device=device)}
    if kind in _ATTN:
        p["attn"] = init_attn_params(generator, cfg, dtype, device)
    elif kind == RECURRENT:
        p["rec"] = rglru_lib.init_rglru(generator, d, cfg.lru_width,
                                        cfg.conv1d_width, dtype, device)
    else:
        raise NotImplementedError(f"layer kind {kind} is not ported yet "
                                  f"(ROADMAP A.13)")
    p["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
    p["ffn"] = init_ffn(generator, d, cfg.d_ff, glu=cfg.glu,
                        bias=cfg.use_ffn_bias, dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters with the reference's tree, shapes, dtypes and
    scales (``param_dtype``; ``log_lambda`` fp32), drawn from
    ``generator`` (which must live on ``device``)."""
    dtype = dtype_of(cfg.param_dtype)
    plan = stack_plan(cfg)
    kw = dict(dtype=dtype, device=resolve_device(device))
    params: Params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": torch.zeros((cfg.d_model,), **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, **kw)
    params["head"] = []
    params["cycles"] = [
        _stack([init_layer(generator, cfg, kind, **kw)
                for _ in range(plan.n_cycles)]) if plan.n_cycles else None
        for kind in plan.pattern]
    params["tail"] = [init_layer(generator, cfg, kind, **kw)
                      for kind in plan.tail_kinds]
    return params


# ===========================================================================
# Full-sequence layer application (prefill)
# ===========================================================================
def _qkv(ap, h: torch.Tensor, cfg: ModelConfig):
    B, S, _ = h.shape
    q, k, v = h @ ap["wq"], h @ ap["wk"], h @ ap["wv"]
    if "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def _out_proj(ap, out: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1) @ ap["wo"]
    return out + ap["bo"] if "bo" in ap else out


def _self_attention(ap, h: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, window: int) -> torch.Tensor:
    """Causal self-attention over the whole sequence on the attention
    kernel (GQA expanded in ``ops.attention``), as the reference's
    Pallas route runs it."""
    if cfg.attn_softcap != 0.0:
        raise NotImplementedError("attention soft-capping (gemma2) is not "
                                  "ported yet (ROADMAP A.13)")
    q, k, v = _qkv(ap, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True, window=window)
    return _out_proj(ap, out)


def _cast_layer(lp, dtype):
    """A layer's floating-point params in the activation dtype (cast at
    use, as the reference does)."""
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point()
                    and a.dtype != dtype else a, lp)


def apply_layer_full(lp: Params, x: torch.Tensor, kind: int,
                     cfg: ModelConfig, positions: torch.Tensor
                     ) -> torch.Tensor:
    """One layer over a full sequence."""
    lp = _cast_layer(lp, x.dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind in _ATTN:
        window = cfg.sliding_window if kind == ATTN_LOCAL else 0
        x = x + _self_attention(lp["attn"], h, positions, cfg, window=window)
    elif kind == RECURRENT:
        x = x + rglru_lib.apply_rglru(lp["rec"], h,
                                      conv_width=cfg.conv1d_width)
    else:
        raise NotImplementedError(f"layer kind {kind} (ROADMAP A.13)")
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + apply_ffn(lp["ffn"], h2, activation=cfg.activation,
                         glu=cfg.glu)


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(dtype_of(cfg.dtype))
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _layers(params, plan: StackPlan):
    """(layer params, kind, where) in stack order; ``where`` is
    ("cycles", pos, c) or ("tail", i, None)."""
    for c in range(plan.n_cycles):
        for pos, kind in enumerate(plan.pattern):
            yield _cycle(params["cycles"][pos], c), kind, ("cycles", pos, c)
    for i, kind in enumerate(plan.tail_kinds):
        yield params["tail"][i], kind, ("tail", i, None)


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward: ``batch["tokens"]`` (B, S) -> final-normed
    hidden (B, S, d)."""
    plan = stack_plan(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for lp, kind, _ in _layers(params, plan):
        x = apply_layer_full(lp, x, kind, cfg, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_from_hidden(params, cfg: ModelConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    logits = hidden @ lm_head_weight(params, cfg).to(hidden.dtype)
    return softcap(logits, cfg.logit_softcap)


# ===========================================================================
# Decode: caches + single-token step
# ===========================================================================
def _attn_cache(cfg: ModelConfig, kind: int, batch: int, seq_len: int,
                dtype, device) -> Params:
    size = seq_len if kind == ATTN_GLOBAL else min(cfg.sliding_window,
                                                   seq_len)
    kv = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "kv_pos": torch.full((batch, size), -1, dtype=torch.int32,
                                 device=device)}


def _layer_state(cfg: ModelConfig, kind: int, batch: int, seq_len: int,
                 dtype, device) -> Params:
    if kind in _ATTN:
        return _attn_cache(cfg, kind, batch, seq_len, dtype, device)
    if kind == RECURRENT:
        return rglru_lib.init_rglru_state(batch, cfg.lru_width,
                                          cfg.conv1d_width, dtype, device)
    raise NotImplementedError(f"layer kind {kind} (ROADMAP A.13)")


def init_cache(params: Params, cfg: ModelConfig, batch: int,
               seq_len: int) -> Params:
    """Decode cache matching the stack plan, on the params' device;
    cycle states carry (n_cycles, B, ...) leaves."""
    plan = stack_plan(cfg)
    dtype = dtype_of(cfg.dtype)
    device = params["embed"].device

    def state(kind):
        return _layer_state(cfg, kind, batch, seq_len, dtype, device)

    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "head": [],
        "cycles": [_stack([state(kind) for _ in range(plan.n_cycles)])
                   if plan.n_cycles else None for kind in plan.pattern],
        "tail": [state(kind) for kind in plan.tail_kinds],
    }


def reset_cache_slots(cache: Params, fresh: Params,
                      reset: torch.Tensor) -> Params:
    """Fresh state (an :func:`init_cache` of the same shape; not all
    zeros: ring caches start at ``kv_pos = -1``) in the rows of the
    slots where ``reset`` (B,) bool is set, the old state elsewhere.
    Without it a refilled slot decodes against the previous request's
    KV rows."""
    def blend(axis):
        def f(a, b):
            if a is None:                    # an empty cycles slot
                return None
            shape = [1] * a.dim()
            shape[axis] = -1
            return torch.where(reset.reshape(shape), b, a)
        return f

    return {"pos": torch.where(reset, fresh["pos"], cache["pos"]),
            "head": tree_map(blend(0), cache["head"], fresh["head"]),
            "tail": tree_map(blend(0), cache["tail"], fresh["tail"]),
            # cycle-stacked states carry (n_cycles, B, ...) leaves
            "cycles": tree_map(blend(1), cache["cycles"], fresh["cycles"])}


def _decode_self_attention(ap, cache, h: torch.Tensor, pos: torch.Tensor,
                           cfg: ModelConfig, kind: int):
    """h (B, 1, d).  Writes the token's k and v at ``pos % size`` of new
    copies of the (ring, for windowed layers) cache and attends over the
    slots holding a position (empty ones sit at INT_MAX, past any
    query).  Returns (out, new cache)."""
    B = h.shape[0]
    q, k, v = _qkv(ap, h, cfg)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = (pos % size).long()
    bidx = torch.arange(B, device=h.device)
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    kv_pos = cache["kv_pos"].clone()
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    kv_pos[bidx, slot] = pos

    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    big = torch.where(kv_pos >= 0, kv_pos,
                      torch.full_like(kv_pos, INT_MAX))
    out = attn_lib.attend(q, k_cache, v_cache, q_positions=positions,
                          kv_positions=big, causal=True, window=window,
                          attn_softcap=cfg.attn_softcap, chunk=0)
    return _out_proj(ap, out), {"k": k_cache, "v": v_cache,
                                "kv_pos": kv_pos}


def apply_layer_decode(lp: Params, state: Params, x: torch.Tensor,
                       kind: int, cfg: ModelConfig, pos: torch.Tensor):
    """One layer, one token.  x (B, 1, d).  Returns (x, new state)."""
    lp = _cast_layer(lp, x.dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind in _ATTN:
        out, new_state = _decode_self_attention(lp["attn"], state, h, pos,
                                                cfg, kind)
    elif kind == RECURRENT:
        out, new_state = rglru_lib.rglru_decode(lp["rec"], h, state,
                                                conv_width=cfg.conv1d_width)
    else:
        raise NotImplementedError(f"layer kind {kind} (ROADMAP A.13)")
    x = x + out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + apply_ffn(lp["ffn"], h2, activation=cfg.activation, glu=cfg.glu)
    return x, new_state


def decode_step(params: Params, cache: Params, cfg: ModelConfig,
                tokens: torch.Tensor):
    """One decode step.  tokens (B, 1) int.  Returns (logits (B, 1, V),
    new cache); ``cache`` is left as it was."""
    plan = stack_plan(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    cyc_states = [[None] * plan.n_cycles for _ in plan.pattern]
    tail_states = []
    for lp, kind, (part, i, c) in _layers(params, plan):
        if part == "cycles":
            x, st = apply_layer_decode(lp, _cycle(cache["cycles"][i], c), x,
                                       kind, cfg, pos)
            cyc_states[i][c] = st
        else:
            x, st = apply_layer_decode(lp, cache["tail"][i], x, kind, cfg,
                                       pos)
            tail_states.append(st)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, x)
    new_cache = {"pos": pos + 1, "head": [],
                 "cycles": [_stack(s) if plan.n_cycles else None
                            for s in cyc_states],
                 "tail": tail_states}
    return logits, new_cache
