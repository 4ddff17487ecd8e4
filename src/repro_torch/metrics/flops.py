"""Analytic accounting (``repro/metrics/flops.py``): a decoder's
parameter count from its config, its active parameters per token, the
roofline's MODEL_FLOPS = 6 N D (train) or 2 N D (prefill, decode), and
U-Net MACs."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT,
                                      RWKV, InputShape, ModelConfig)


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameter count from the config (matches ``model.init``'s tree)."""
    if cfg.arch_type == "unet":
        raise ValueError("unet params counted from the pytree")
    d, hd = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    n = cfg.vocab_size * d                     # embed
    if not cfg.tie_embeddings:
        n += d * cfg.vocab_size                # lm head
    n += d                                     # final norm

    def attn():
        if cfg.mla is not None:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank
                    + m.q_lora_rank * Hq * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank
                    + m.kv_lora_rank * Hq * (m.qk_nope_head_dim
                                             + m.v_head_dim)
                    + Hq * m.v_head_dim * d)
        a = d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
        if cfg.use_qkv_bias:
            a += Hq * hd + 2 * Hkv * hd
        if cfg.use_attn_out_bias:
            a += d
        return a

    def ffn(d_ff):
        f = d * d_ff * (3 if cfg.glu else 2)
        if cfg.use_ffn_bias:
            f += d_ff + d
        return f

    def moe_layer():
        m = cfg.moe
        e = d * m.num_experts                   # router
        e += m.num_experts * (3 * d * m.d_expert)
        if m.num_shared_experts:
            e += 3 * d * m.d_shared
        return e

    def rglru():
        W = cfg.lru_width
        return (2 * d * W + cfg.conv1d_width * W + W
                + 2 * (W * W + W) + W + W * d)

    def rwkv_layer():
        dh = Hq * hd
        tm = (d + 5 * d + 5 * d * 32 + 5 * 32 * d      # mus + loras
              + dh + d * 64 + 64 * dh + Hq * hd         # decay + u
              + 4 * d * dh + dh * d + dh)               # r,k,v,g,o, ln
        cm = 2 * d + d * cfg.d_ff + cfg.d_ff * d + d * d
        return tm + cm

    n_head_layers = cfg.moe.first_dense_layers if cfg.moe else 0
    for i, kind in enumerate(cfg.layer_kinds()):
        n += d  # ln1
        if kind in (ATTN_GLOBAL, ATTN_LOCAL):
            n += attn()
            n += d  # ln2
            if cfg.moe is not None and i >= n_head_layers:
                n += moe_layer()
            else:
                n += ffn(cfg.d_ff)
        elif kind == RECURRENT:
            n += rglru() + d + ffn(cfg.d_ff)
        elif kind == RWKV:
            n += rwkv_layer() + d
    if cfg.arch_type == "encdec":
        per_enc = d + attn() + d + ffn(cfg.d_ff)
        n += cfg.num_encoder_layers * per_enc + d
        # decoder cross-attention (one per decoder layer)
        n += cfg.num_layers * (d + attn())
    return int(n)


def active_params(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE: only routed experts count)."""
    total = count_params_analytic(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    n_moe_layers = cfg.num_layers - m.first_dense_layers
    inactive = n_moe_layers * (m.num_experts - m.experts_per_token) \
        * per_expert
    return int(total - inactive)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6*N_active*D (train: fwd+bwd) or 2*N_active*D
    (prefill/decode: fwd only), the roofline's useful-compute basis."""
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    factor = 6.0 if shape.mode == "train" else 2.0
    return factor * active_params(cfg) * tokens


def unet_macs(params, image_size: int, masks=None) -> float:
    """Analytic MACs of one U-Net forward pass (Table III/IV accounting).

    Convolutions dominate; dense layers + attention included.

    ``masks``: optional sparse-phase prune masks keyed by PruneGroup
    name (the ``apply_unet(masks=)`` contract) — the count then reflects
    the *served* compute of the masked forward: each ResBlock's
    conv1/temb output and conv2 input shrink to the group's kept-channel
    count, and each attention block's qkv/proj GEMMs likewise.  The
    attention score/value einsums stay full-width (pruned channels are
    zeroed, not removed, there), so masked MACs are the honest cost of
    the static-sparsity serving path, not a naive ``(1-ratio)`` scaling.
    """
    def kept(name: str, size: int) -> int:
        if masks is None or name not in masks:
            return size
        m = masks[name]
        if isinstance(m, torch.Tensor):
            return int((m != 0).sum())
        return int(np.sum(np.asarray(m) != 0))

    def conv_macs(w, res, cin_kept=None, cout_kept=None):
        kh, kw, cin, cout = w.shape
        cin = cin if cin_kept is None else cin_kept
        cout = cout if cout_kept is None else cout_kept
        return kh * kw * cin * cout * res * res

    def resblock_macs(rp, res, name):
        k = kept(name, rp["conv1"]["w"].shape[-1])
        m = conv_macs(rp["conv1"]["w"], res, cout_kept=k)
        m += conv_macs(rp["conv2"]["w"], res, cin_kept=k)
        if "skip" in rp:
            m += conv_macs(rp["skip"]["w"], res)
        m += rp["temb"]["w"].shape[0] * k
        return m

    def attnblock_macs(ap, res, name):
        c = ap["proj"]["w"].shape[2]
        k = kept(name, c)
        m = conv_macs(ap["qkv"]["w"], res, cout_kept=3 * k)
        m += conv_macs(ap["proj"]["w"], res, cin_kept=k)
        m += 2 * (res * res) ** 2 * c
        return m

    # Explicit traversal mirroring apply_unet resolution changes.
    total = 0.0
    res = image_size
    total += conv_macs(params["conv_in"]["w"], res)
    for lvl, lvl_p in enumerate(params["down"]):
        for bi, blk in enumerate(lvl_p["blocks"]):
            total += resblock_macs(blk["res"], res,
                                   f"down/{lvl}/blocks/{bi}/res")
            if "attn" in blk:
                total += attnblock_macs(blk["attn"], res,
                                        f"down/{lvl}/blocks/{bi}/attn")
        if "down" in lvl_p:
            res //= 2
            total += conv_macs(lvl_p["down"]["w"], res)
    total += resblock_macs(params["mid"]["res1"], res, "mid/res1")
    total += attnblock_macs(params["mid"]["attn"], res, "mid/attn")
    total += resblock_macs(params["mid"]["res2"], res, "mid/res2")
    for lvl, lvl_p in enumerate(params["up"]):
        for bi, blk in enumerate(lvl_p["blocks"]):
            total += resblock_macs(blk["res"], res,
                                   f"up/{lvl}/blocks/{bi}/res")
            if "attn" in blk:
                total += attnblock_macs(blk["attn"], res,
                                        f"up/{lvl}/blocks/{bi}/attn")
        if "up" in lvl_p:
            res *= 2
            total += conv_macs(lvl_p["up"]["w"], res)
    total += conv_macs(params["conv_out"]["w"], res)
    return total
