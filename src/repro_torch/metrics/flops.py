"""Analytic U-Net MACs (``repro/metrics/flops.py:unet_macs``)."""
from __future__ import annotations

import numpy as np
import torch


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
