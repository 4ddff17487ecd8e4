"""Transformer stack (``repro/models/transformer.py``): global and
local attention layers (GQA/MQA, gemma2's attention soft-capping),
DeepSeek's multi-head latent attention (MLA) and RG-LRU recurrent
layers, each with a dense FFN or a mixture of experts (MoE), or with
command-r's parallel attention and FFN block; RWKV-6 layers (time-mix
and channel-mix); whisper's bidirectional encoder and the decoder's
cross-attention over its output (encdec), and the VLM's image
embeddings before the token embeddings; the full-sequence forward
(prefill, and training with ``remat``), the chunked cross-entropy, and
single-token decode with per-kind caches (ring-buffer KV for windowed
attention, full KV for global attention, the latent cache for MLA, O(1)
states for RG-LRU and RWKV, the encoder output for encdec).

Parameters are the reference's tree: ``head`` (unstacked leading
layers: an MoE model's dense-FFN layers), ``cycles`` (one tree per
position in the layer pattern, each leaf stacked over the pattern's
repetitions on its first axis) and ``tail`` (the pattern's remainder),
so :mod:`repro_torch.convert` carries weights across unchanged.  The
reference scans the cycles with ``lax.scan``; here a Python loop walks
the stacked leaves' first axis.

On a CUDA tensor the forward's RG-LRU recurrences launch the scan
kernel and its RWKV layers the WKV kernel (and their gradients the
backward kernels; the decode step's WKV is the same kernel at one
token), and its causal GQA/MHA self-attention without soft-capping the
attention kernel (``models/ops.py:attention``, as the reference's
Pallas route, with the reference's dense recompute backward).  Everything else attends in plain
ops (``attention.attend``, in q blocks of ATTN_CHUNK), as the
reference's route does: soft-capped layers (all of gemma2's), the
encoder's bidirectional layers, every cross-attention, and MLA
(``models/mla.py``).  The dense projections and the expert products are
plain ``@`` and ``bmm``, as the reference leaves them to XLA outside
any kernel, and the decode step is plain tensor ops, as the reference's
is.  ``remat`` is the reference's ``ApplyOptions.remat``: each pattern
cycle, each encoder block and each cross-entropy chunk runs under
``torch.utils.checkpoint``, so the backward recomputes it (its kernels
launch again) instead of holding its activations; the head layers are
not recomputed, as in the reference.  ``wkv_chunk`` is the reference's
``ApplyOptions.wkv_chunk``: RWKV's chunk-parallel form (0, the default,
is the exact recurrence).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      RWKV, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ops
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       embed_init, rms_norm, softcap)
from repro_torch.models.ffn import apply_ffn, init_ffn
from repro_torch.tree import tree_map

Params = Dict[str, Any]
INT_MAX = torch.iinfo(torch.int32).max
_ATTN = (ATTN_GLOBAL, ATTN_LOCAL)
# the reference's ApplyOptions.attn_chunk: the plain route's q-block size
ATTN_CHUNK = 1024


# ===========================================================================
# Stack plan
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class StackPlan:
    n_head: int                 # leading unstacked layers (dense-FFN for MoE)
    n_cycles: int               # repetitions of the pattern
    pattern: Tuple[int, ...]
    tail_kinds: Tuple[int, ...]


def stack_plan(cfg: ModelConfig) -> StackPlan:
    n_head = cfg.moe.first_dense_layers if cfg.moe else 0
    if n_head and len(cfg.layer_pattern) != 1:
        raise ValueError("head layers need a uniform layer pattern")
    rem = cfg.num_layers - n_head
    plen = len(cfg.layer_pattern)
    return StackPlan(n_head=n_head, n_cycles=rem // plen,
                     pattern=cfg.layer_pattern,
                     tail_kinds=cfg.layer_pattern[: rem % plen])


def _stacked(make: Callable[[], Any], n: int):
    """One tree whose leaves stack ``n`` trees from ``make()`` on a new
    first axis, in call order.  Each tree is copied into its row and
    dropped, so at most one more tree than the result is alive (a full
    model's stacked expert leaves would not fit twice); one tree is
    viewed with a new axis, not copied."""
    first = make()
    if n == 1:
        return tree_map(lambda t: t[None], first)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for c in range(n):
        tree_map(lambda o, t: o[c].copy_(t), out, first if c == 0
                 else make())
    return out


def _cycle(stacked, c: int):
    """Cycle ``c``'s tree out of a stacked one (views)."""
    return tree_map(lambda t: t[c], stacked)


def _layer_is_moe(cfg: ModelConfig, kind: int) -> bool:
    return cfg.moe is not None and kind in _ATTN


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
               is_moe: bool, cross_attn: bool = False, dtype=torch.float32,
               device="cpu") -> Params:
    """One layer's params; ``cross_attn`` adds an attention layer's
    ``ln_cross`` and ``cross`` (an encdec decoder layer).  A parallel
    block keeps ``ln2``, unused, as the reference's tree does.  An RWKV
    layer is ``ln1``, ``tmix``, ``ln2`` and ``cmix``."""
    d = cfg.d_model
    p: Params = {"ln1": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == RWKV:
        p["tmix"] = rwkv_lib.init_rwkv_tmix(generator, d, cfg.num_heads,
                                            cfg.head_dim, dtype, device)
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
        p["cmix"] = rwkv_lib.init_rwkv_cmix(generator, d, cfg.d_ff, dtype,
                                            device)
        return p
    if kind in _ATTN and cfg.mla is not None:
        p["mla"] = mla_lib.init_mla(generator, d, cfg.num_heads, cfg.mla,
                                    dtype, device)
    elif kind in _ATTN:
        p["attn"] = init_attn_params(generator, cfg, dtype, device)
    elif kind == RECURRENT:
        p["rec"] = rglru_lib.init_rglru(generator, d, cfg.lru_width,
                                        cfg.conv1d_width, dtype, device)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    if cross_attn and kind in _ATTN:
        p["ln_cross"] = torch.zeros((d,), dtype=dtype, device=device)
        p["cross"] = init_attn_params(generator, cfg, dtype, device)
    p["ln2"] = torch.zeros((d,), dtype=dtype, device=device)
    if is_moe:
        p["moe"] = moe_lib.init_moe(generator, d, cfg.moe, dtype=dtype,
                                    device=device)
    else:
        p["ffn"] = init_ffn(generator, d, cfg.d_ff, glu=cfg.glu,
                            bias=cfg.use_ffn_bias, dtype=dtype,
                            device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random parameters with the reference's tree, shapes, dtypes and
    scales (``param_dtype``; ``log_lambda`` and the MoE router fp32),
    drawn from ``generator`` (which must live on ``device``): the head
    layers, then each pattern position's cycles, then the tail, then an
    encdec model's ``encoder`` (its blocks stacked, no cross-attention,
    and its final norm)."""
    dtype = dtype_of(cfg.param_dtype)
    plan = stack_plan(cfg)
    kw = dict(dtype=dtype, device=resolve_device(device))
    cross = cfg.arch_type == "encdec"
    params: Params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, **kw),
        "final_norm": torch.zeros((cfg.d_model,), **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, **kw)
    # head layers: always dense-FFN
    params["head"] = [init_layer(generator, cfg, cfg.layer_pattern[0],
                                 is_moe=False, cross_attn=cross, **kw)
                      for _ in range(plan.n_head)]
    params["cycles"] = [
        _stacked(lambda kind=kind: init_layer(
            generator, cfg, kind, is_moe=_layer_is_moe(cfg, kind),
            cross_attn=cross, **kw), plan.n_cycles)
        if plan.n_cycles else None
        for kind in plan.pattern]
    params["tail"] = [init_layer(generator, cfg, kind,
                                 is_moe=_layer_is_moe(cfg, kind),
                                 cross_attn=cross, **kw)
                      for kind in plan.tail_kinds]
    if cross:
        params["encoder"] = {
            "blocks": _stacked(lambda: init_layer(
                generator, cfg, ATTN_GLOBAL, is_moe=False, **kw),
                max(cfg.num_encoder_layers, 1)),
            "final_norm": torch.zeros((cfg.d_model,), **kw)}
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
                    cfg: ModelConfig, *, window: int,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention over the whole sequence, routed as the reference
    routes it: causal without soft-capping on the attention kernel (GQA
    expanded in ``ops.attention``), anything else (soft-capped, or
    bidirectional) through the plain ``attend`` in q blocks of
    ATTN_CHUNK."""
    q, k, v = _qkv(ap, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if causal and cfg.attn_softcap == 0.0:
        out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=window)
    else:
        out = attn_lib.attend(q, k, v, q_positions=positions,
                              kv_positions=positions, causal=causal,
                              window=window, attn_softcap=cfg.attn_softcap,
                              chunk=ATTN_CHUNK)
    return _out_proj(ap, out)


def _cross_attention(ap, h: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ModelConfig, *, biases: bool) -> torch.Tensor:
    """Queries from the decoder's h (B, S, d), keys and values from the
    encoder's output (B, Se, d), no mask and no RoPE, in plain ``attend``.
    ``biases``: add the q/k/v biases, as the reference's prefill does; its
    decode step leaves them out and adds only ``bo``."""
    B, S, _ = h.shape
    Se = enc_out.shape[1]
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = h @ ap["wq"], enc_out @ ap["wk"], enc_out @ ap["wv"]
    if biases and "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    out = attn_lib.attend(
        q.reshape(B, S, Hq, hd), k.reshape(B, Se, Hkv, hd),
        v.reshape(B, Se, Hkv, hd),
        q_positions=torch.arange(S, dtype=torch.int32, device=h.device),
        kv_positions=torch.arange(Se, dtype=torch.int32, device=h.device),
        causal=False, window=0, chunk=ATTN_CHUNK)
    return _out_proj(ap, out)


def _cast_layer(lp, dtype):
    """A layer's floating-point params in the activation dtype (cast at
    use, as the reference does; the fp32 MoE router too)."""
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point()
                    and a.dtype != dtype else a, lp)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn_or_moe(lp, h2: torch.Tensor, cfg: ModelConfig):
    """The layer's FFN half: (out, aux), aux 0 for a dense FFN."""
    if "moe" in lp:
        return moe_lib.apply_moe(lp["moe"], h2, cfg.moe,
                                 activation=cfg.activation)
    return _ffn_only(lp, h2, cfg), _zero(h2)


def _ffn_only(lp, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return apply_ffn(lp["ffn"], h, activation=cfg.activation, glu=cfg.glu)


def apply_layer_full(lp: Params, x: torch.Tensor, kind: int,
                     cfg: ModelConfig, positions: torch.Tensor, *,
                     enc_out: Optional[torch.Tensor] = None,
                     causal: bool = True, wkv_chunk: int = 0):
    """One layer over a full sequence.  Returns (x, aux loss).  An
    attention layer with ``cfg.parallel_block`` adds attention and FFN
    of one normed input, ``x + attn(h) + ffn(h)``; one with ``cross``
    attends to ``enc_out`` between its self-attention and its FFN.
    ``causal=False``: the encoder's bidirectional layers.  An RWKV layer
    is time-mix then channel-mix, each on its normed input, its state
    discarded (``wkv_chunk``: see :func:`rwkv6.apply_tmix`)."""
    lp = _cast_layer(lp, x.dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    if kind == RWKV:
        tm_out, _ = rwkv_lib.apply_tmix(lp["tmix"], h, cfg.num_heads,
                                        cfg.head_dim, wkv_chunk=wkv_chunk)
        x = x + tm_out
        cm_out, _ = rwkv_lib.apply_cmix(lp["cmix"],
                                        rms_norm(x, lp["ln2"], cfg.norm_eps))
        return x + cm_out, _zero(x)
    if kind == RECURRENT:
        x = x + rglru_lib.apply_rglru(lp["rec"], h,
                                      conv_width=cfg.conv1d_width)
    elif kind not in _ATTN:
        raise ValueError(f"unknown layer kind {kind}")
    else:
        if "mla" in lp:
            attn_out = mla_lib.apply_mla(lp["mla"], h, cfg.mla,
                                         cfg.num_heads, positions,
                                         rope_theta=cfg.rope_theta,
                                         chunk=ATTN_CHUNK, window=window)
        else:
            attn_out = _self_attention(lp["attn"], h, positions, cfg,
                                       window=window, causal=causal)
        if cfg.parallel_block:
            return x + attn_out + _ffn_only(lp, h, cfg), _zero(x)
        x = x + attn_out
        if "cross" in lp:
            hc = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
            x = x + _cross_attention(lp["cross"], hc, enc_out, cfg,
                                     biases=True)
    out, aux = _ffn_or_moe(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + out, aux


def _encoder_block(lp, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    return apply_layer_full(lp, x, ATTN_GLOBAL, cfg, positions,
                            causal=False)[0]


def apply_encoder(params: Params, frames: torch.Tensor, cfg: ModelConfig,
                  *, remat: bool = False) -> torch.Tensor:
    """Whisper's encoder: bidirectional global-attention blocks (plain
    ``attend``) over the frame embeddings (B, Se, d), then its final
    norm.  ``remat``: each block is recomputed in the backward (the
    reference's ``jax.checkpoint`` of its scan body)."""
    enc = params["encoder"]
    x = frames
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for c in range(enc["blocks"]["ln1"].shape[0]):
        lp = _cycle(enc["blocks"], c)
        if remat:
            x = checkpoint(_encoder_block, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _encoder_block(lp, x, cfg, positions)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(dtype_of(cfg.dtype))
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _apply_cycle(cycle_params, x: torch.Tensor, aux: torch.Tensor,
                 cfg: ModelConfig, positions: torch.Tensor,
                 enc_out: Optional[torch.Tensor], wkv_chunk: int = 0):
    """One repetition of the layer pattern: (x, aux) -> (x, aux)."""
    for lp, kind in zip(cycle_params, cfg.layer_pattern):
        x, a = apply_layer_full(lp, x, kind, cfg, positions, enc_out=enc_out,
                                wkv_chunk=wkv_chunk)
        aux = aux + a
    return x, aux


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = False,
            wkv_chunk: int = 0):
    """Full-sequence forward -> (final-normed hidden (B, S, d), aux loss:
    the MoE layers' summed load-balance terms, fp32 0-d).

    ``batch["tokens"]`` (B, S_text); a VLM's ``image_embeds``
    (B, N_img, d) go before the token embeddings, in the activation
    dtype (S = N_img + S_text); an encdec model's ``frames`` (B, Se, d)
    run through :func:`apply_encoder`, whose output every decoder layer
    attends to.  ``remat``: each pattern cycle and each encoder block is
    recomputed in the backward (the reference's ``jax.checkpoint`` of
    its scan bodies).  ``wkv_chunk``: the RWKV layers' chunk-parallel
    form (0: the exact recurrence)."""
    plan = stack_plan(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    enc_out = None
    if cfg.arch_type == "vlm":
        x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
    elif cfg.arch_type == "encdec":
        enc_out = apply_encoder(params, batch["frames"].to(x.dtype), cfg,
                                remat=remat)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = _zero(x)
    for lp in params["head"]:
        x, a = apply_layer_full(lp, x, cfg.layer_pattern[0], cfg, positions,
                                enc_out=enc_out, wkv_chunk=wkv_chunk)
        aux = aux + a
    for c in range(plan.n_cycles):
        cyc = [_cycle(params["cycles"][pos], c)
               for pos in range(len(plan.pattern))]
        if remat:
            x, aux = checkpoint(_apply_cycle, cyc, x, aux, cfg, positions,
                                enc_out, wkv_chunk, use_reentrant=False)
        else:
            x, aux = _apply_cycle(cyc, x, aux, cfg, positions, enc_out,
                                  wkv_chunk)
    for lp, kind in zip(params["tail"], plan.tail_kinds):
        x, a = apply_layer_full(lp, x, kind, cfg, positions, enc_out=enc_out,
                                wkv_chunk=wkv_chunk)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_from_hidden(params, cfg: ModelConfig,
                       hidden: torch.Tensor) -> torch.Tensor:
    logits = hidden @ lm_head_weight(params, cfg).to(hidden.dtype)
    return softcap(logits, cfg.logit_softcap)


def _xent_chunk(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                cfg: ModelConfig):
    """(sum of the kept positions' losses, their count) of one chunk, both
    fp32.  The logits stay in the activation dtype, so the cotangent into
    the backbone does too; only the reductions are fp32."""
    logits = softcap(h @ w.to(h.dtype), cfg.logit_softcap)
    lmax = logits.float().amax(dim=-1, keepdim=True).detach()
    shifted = logits - lmax.to(logits.dtype)
    lse = torch.log(torch.sum(torch.exp(shifted).float(), dim=-1)) \
        + lmax[..., 0]
    yc = torch.clamp(y, 0, cfg.vocab_size - 1).long()
    correct = torch.gather(logits, -1, yc[..., None])[..., 0].float()
    mask = (y >= 0).float()
    return torch.sum((lse - correct) * mask), torch.sum(mask)


def chunked_xent(params, cfg: ModelConfig, hidden: torch.Tensor,
                 labels: torch.Tensor, *, chunk: int = 512,
                 remat: bool = True) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) logits.

    hidden (B, S, d); labels (B, S) int, -1 = ignore.  The sequence goes
    in chunks of ``chunk`` positions (shrunk until it divides S), each
    recomputed in the backward under ``remat``.  Returns the mean loss
    over the kept positions (fp32 0-d)."""
    B, S, d = hidden.shape
    w = lm_head_weight(params, cfg)
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        h, y = hidden[:, i:i + chunk], labels[:, i:i + chunk]
        if remat:
            part, n = checkpoint(_xent_chunk, h, y, w, cfg,
                                 use_reentrant=False)
        else:
            part, n = _xent_chunk(h, y, w, cfg)
        loss_sum, count = loss_sum + part, count + n
    return loss_sum / torch.clamp(count, min=1.0)


# ===========================================================================
# Decode: caches + single-token step
# ===========================================================================
def _attn_cache(cfg: ModelConfig, kind: int, batch: int, seq_len: int,
                dtype, device) -> Params:
    if cfg.mla is not None:
        # the latent and the shared RoPE key, written at pos (no ring)
        return {"c": torch.zeros((batch, seq_len, cfg.mla.kv_lora_rank),
                                 dtype=dtype, device=device),
                "kr": torch.zeros((batch, seq_len,
                                   cfg.mla.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
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
    if kind == RWKV:
        return rwkv_lib.init_rwkv_state(batch, cfg.d_model, cfg.num_heads,
                                        cfg.head_dim, dtype, device)
    raise ValueError(f"unknown layer kind {kind}")


def init_cache(params: Params, cfg: ModelConfig, batch: int,
               seq_len: int, *,
               enc_out: Optional[torch.Tensor] = None) -> Params:
    """Decode cache matching the stack plan, on the params' device;
    cycle states carry (n_cycles, B, ...) leaves.  An encdec model's
    cache holds ``enc_out`` (B, Se, d), which its cross-attention reads
    at every step (required)."""
    plan = stack_plan(cfg)
    dtype = dtype_of(cfg.dtype)
    device = params["embed"].device

    def state(kind):
        return _layer_state(cfg, kind, batch, seq_len, dtype, device)

    cache = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "head": [state(cfg.layer_pattern[0]) for _ in range(plan.n_head)],
        "cycles": [_stacked(lambda kind=kind: state(kind), plan.n_cycles)
                   if plan.n_cycles else None for kind in plan.pattern],
        "tail": [state(kind) for kind in plan.tail_kinds],
    }
    if cfg.arch_type == "encdec":
        if enc_out is None:
            raise ValueError("an encdec decode cache needs enc_out")
        cache["enc_out"] = enc_out
    return cache


def reset_cache_slots_(cache: Params, fresh: Params,
                       reset: torch.Tensor) -> Params:
    """Fresh state in the rows of the slots where ``reset`` (B,) bool is
    set, written into ``cache`` in place, which is returned.  ``fresh``
    is an :func:`init_cache` of the same seq_len and batch B or 1 (a
    fresh state is the same in every row; not all zeros: ring caches
    start at ``kv_pos = -1``).  Without it a refilled slot decodes
    against the previous request's KV rows."""
    rows = torch.nonzero(reset).reshape(-1).tolist()

    def put(axis):
        def f(a, b):
            # row by row: a one-slot fresh broadcasts, and no temporary
            # as large as the reset rows of a stacked leaf is made
            for r in rows:
                a.select(axis, r).copy_(
                    b.select(axis, r if b.shape[axis] == a.shape[axis]
                             else 0))
        return f

    put(0)(cache["pos"], fresh["pos"])
    tree_map(put(0), cache["head"], fresh["head"])
    tree_map(put(0), cache["tail"], fresh["tail"])
    # cycle-stacked states carry (n_cycles, B, ...) leaves
    tree_map(put(1), cache["cycles"], fresh["cycles"])
    if "enc_out" in cache:
        put(0)(cache["enc_out"], fresh["enc_out"])
    return cache


def reset_cache_slots(cache: Params, fresh: Params,
                      reset: torch.Tensor) -> Params:
    """:func:`reset_cache_slots_` on a copy: ``cache`` is left as it was."""
    return reset_cache_slots_(tree_map(torch.clone, cache), fresh, reset)


def _decode_self_attention_(ap, cache, h: torch.Tensor, pos: torch.Tensor,
                            cfg: ModelConfig, kind: int) -> torch.Tensor:
    """h (B, 1, d).  Writes the token's k and v at ``pos % size`` of the
    (ring, for windowed layers) cache in place and attends over the
    slots holding a position (empty ones sit at INT_MAX, past any
    query)."""
    B = h.shape[0]
    q, k, v = _qkv(ap, h, cfg)
    positions = pos[:, None]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = (pos % size).long()
    bidx = torch.arange(B, device=h.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["kv_pos"][bidx, slot] = pos

    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    kv_pos = cache["kv_pos"]
    big = torch.where(kv_pos >= 0, kv_pos,
                      torch.full_like(kv_pos, INT_MAX))
    out = attn_lib.attend(q, cache["k"], cache["v"], q_positions=positions,
                          kv_positions=big, causal=True, window=window,
                          attn_softcap=cfg.attn_softcap, chunk=0)
    return _out_proj(ap, out)


def apply_layer_decode_(lp: Params, state: Params, x: torch.Tensor,
                        kind: int, cfg: ModelConfig, pos: torch.Tensor, *,
                        enc_out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """One layer, one token.  x (B, 1, d).  Writes the layer's new state
    into ``state`` in place and returns x.  The cross-attention over
    ``enc_out`` leaves out the q/k/v biases, as the reference's decode
    step does.  An RWKV layer's WKV state ``S`` is written by the
    kernel's one-token launch, its ``shift_t`` and ``shift_c`` by
    copies."""
    lp = _cast_layer(lp, x.dtype)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    window = cfg.sliding_window if kind == ATTN_LOCAL else 0
    if kind == RWKV:
        tm_out, _ = rwkv_lib.apply_tmix(
            lp["tmix"], h, cfg.num_heads, cfg.head_dim,
            state={"S": state["S"], "shift": state["shift_t"]}, inplace=True)
        x = x + tm_out
        cm_out, _ = rwkv_lib.apply_cmix(
            lp["cmix"], rms_norm(x, lp["ln2"], cfg.norm_eps),
            state={"shift": state["shift_c"]}, inplace=True)
        return x + cm_out
    if "mla" in lp:
        out, _, _ = mla_lib.mla_decode(lp["mla"], h, state["c"], state["kr"],
                                       pos, cfg.mla, cfg.num_heads,
                                       rope_theta=cfg.rope_theta,
                                       window=window)
    elif kind in _ATTN:
        out = _decode_self_attention_(lp["attn"], state, h, pos, cfg, kind)
    elif kind == RECURRENT:
        out, new = rglru_lib.rglru_decode(lp["rec"], h, state,
                                          conv_width=cfg.conv1d_width)
        for key, t in new.items():
            state[key].copy_(t)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    if kind in _ATTN and cfg.parallel_block:
        return x + out + _ffn_only(lp, h, cfg)
    x = x + out
    if "cross" in lp:
        hc = rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        x = x + _cross_attention(lp["cross"], hc, enc_out, cfg,
                                 biases=False)
    out, _ = _ffn_or_moe(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + out


def decode_step_(params: Params, cache: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """One decode step that writes into ``cache`` in place (every layer's
    new state, and ``pos`` + 1): a serving loop that owns its cache holds
    one copy, not two.  tokens (B, 1) int.  Returns logits (B, 1, V)."""
    plan = stack_plan(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    kw = dict(enc_out=cache.get("enc_out"))
    for lp, st in zip(params["head"], cache["head"]):
        x = apply_layer_decode_(lp, st, x, cfg.layer_pattern[0], cfg, pos,
                                **kw)
    for c in range(plan.n_cycles):
        for i, kind in enumerate(plan.pattern):
            x = apply_layer_decode_(_cycle(params["cycles"][i], c),
                                    _cycle(cache["cycles"][i], c), x, kind,
                                    cfg, pos, **kw)
    for lp, st, kind in zip(params["tail"], cache["tail"], plan.tail_kinds):
        x = apply_layer_decode_(lp, st, x, kind, cfg, pos, **kw)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return logits_from_hidden(params, cfg, x)


def decode_step(params: Params, cache: Params, cfg: ModelConfig,
                tokens: torch.Tensor):
    """One decode step.  tokens (B, 1) int.  Returns (logits (B, 1, V),
    new cache); ``cache`` is left as it was (:func:`decode_step_` on a
    copy)."""
    new_cache = tree_map(torch.clone, cache)
    return decode_step_(params, new_cache, cfg, tokens), new_cache
