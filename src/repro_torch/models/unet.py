"""DDPM U-Net (Ho et al. 2020) in PyTorch, the port of
``repro/models/unet.py``.

Parameters are the reference's tree: nested dicts and lists of tensors
with the same keys, NHWC activations, (kh, kw, cin, cout) conv weights
and (K, N) dense weights, so pruning groups, checkpoints and
:mod:`repro_torch.convert` apply unchanged.  Every GEMM and attention
block runs through :mod:`repro_torch.models.ops`.

``apply_unet(..., masks=)`` runs the masked forward: per-group 0/1 masks
keyed by PruneGroup name are applied as column/row masks on each block's
GEMMs (host numpy masks take the gather route that serving uses).

``apply_unet(..., clients=C)`` is the stacked forward of the vectorized
round engine: every parameter leaf has a leading (C,) axis and x holds
the C clients' batches one after another, (C * B, H, W, ch).  The ops
see the stacked weights and run each GEMM as one client-batched launch
(:mod:`repro_torch.models.ops`); attention folds the clients into its
batch axis.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ops
from repro_torch.models.common import group_norm, sinusoidal_embedding

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initialisation: the reference's shapes and distributions
# ---------------------------------------------------------------------------

class _Init:
    def __init__(self, generator: torch.Generator, device: torch.device):
        self.g = generator
        self.device = device

    def normal(self, shape, std):
        return torch.randn(shape, generator=self.g, device=self.device) * std

    def zeros(self, n):
        return torch.zeros((n,), device=self.device)

    def conv(self, kh, kw, cin, cout, scale=1.0):
        return {"w": self.normal((kh, kw, cin, cout),
                                 scale / (kh * kw * cin) ** 0.5),
                "b": self.zeros(cout)}

    def dense(self, cin, cout, scale=1.0):
        return {"w": self.normal((cin, cout), scale / cin ** 0.5),
                "b": self.zeros(cout)}

    def norm(self, c):
        return {"scale": torch.ones((c,), device=self.device),
                "bias": self.zeros(c)}

    def resblock(self, cin, cout, temb_dim):
        p = {"norm1": self.norm(cin),
             "conv1": self.conv(3, 3, cin, cout),
             "temb": self.dense(temb_dim, cout),
             "norm2": self.norm(cout),
             "conv2": self.conv(3, 3, cout, cout, scale=1e-6)}
        if cin != cout:
            p["skip"] = self.conv(1, 1, cin, cout)
        return p

    def attnblock(self, c):
        return {"norm": self.norm(c),
                "qkv": self.conv(1, 1, c, 3 * c),
                "proj": self.conv(1, 1, c, c, scale=1e-6)}


def init_unet(cfg: ModelConfig, generator: torch.Generator,
              device="cuda") -> Params:
    """Random U-Net parameters with the reference's tree, shapes and
    distributions (normal / sqrt(fan_in); conv2, proj and conv_out at
    scale 1e-6; zero biases; unit norm scales), drawn from ``generator``
    (which must live on ``device``)."""
    init = _Init(generator, torch.device(device))
    ch = cfg.base_channels
    temb_dim = ch * 4
    params: Params = {
        "temb1": init.dense(ch, temb_dim),
        "temb2": init.dense(temb_dim, temb_dim),
        "conv_in": init.conv(3, 3, cfg.in_channels, ch),
        "norm_out": init.norm(ch),
        "conv_out": init.conv(3, 3, ch, cfg.in_channels, scale=1e-6),
    }
    res = cfg.image_size
    down: List[Params] = []
    chans = [ch]
    cur = ch
    for lvl, mult in enumerate(cfg.channel_mults):
        cout = ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blk = {"res": init.resblock(cur, cout, temb_dim)}
            cur = cout
            if res in cfg.attn_resolutions:
                blk["attn"] = init.attnblock(cur)
            blocks.append(blk)
            chans.append(cur)
        lvl_p: Params = {"blocks": blocks}
        if lvl != len(cfg.channel_mults) - 1:
            lvl_p["down"] = init.conv(3, 3, cur, cur)
            chans.append(cur)
            res //= 2
        down.append(lvl_p)
    params["down"] = down
    params["mid"] = {"res1": init.resblock(cur, cur, temb_dim),
                     "attn": init.attnblock(cur),
                     "res2": init.resblock(cur, cur, temb_dim)}
    up: List[Params] = []
    for lvl, mult in reversed(list(enumerate(cfg.channel_mults))):
        cout = ch * mult
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            skip_c = chans.pop()
            blk = {"res": init.resblock(cur + skip_c, cout, temb_dim)}
            cur = cout
            if res in cfg.attn_resolutions:
                blk["attn"] = init.attnblock(cur)
            blocks.append(blk)
        lvl_p = {"blocks": blocks}
        if lvl != 0:
            lvl_p["up"] = init.conv(3, 3, cur, cur)
            res *= 2
        up.append(lvl_p)
    params["up"] = up
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _scaled(v: torch.Tensor, mask) -> torch.Tensor:
    return v if mask is None else \
        v * torch.as_tensor(mask, device=v.device).to(v.dtype)


def apply_resblock(p, x, temb, *, mask=None):
    """``mask`` (cout,): the block's PruneGroup mask over its internal
    channels (conv1/temb output columns, norm2 affine, conv2 input rows)."""
    h = F.silu(group_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]))
    h = ops.conv(p["conv1"], h, col_mask=mask)
    h = h + ops.dense(p["temb"], F.silu(temb), col_mask=mask)[:, None, None, :]
    h = F.silu(group_norm(h, _scaled(p["norm2"]["scale"], mask),
                          _scaled(p["norm2"]["bias"], mask)))
    h = ops.conv(p["conv2"], h, row_mask=mask)
    skip = ops.conv(p["skip"], x) if "skip" in p else x
    return skip + h


def apply_attnblock(p, x, *, mask=None):
    """``mask`` (c,): per-channel attention mask, tiled over the q/k/v
    thirds of the qkv projection and the proj input rows."""
    B, H, W, C = x.shape
    h = group_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    qkv_mask = None
    if mask is not None:
        qkv_mask = np.concatenate([mask] * 3) if ops.is_static_mask(mask) \
            else torch.cat([mask] * 3)
    qkv = ops.conv(p["qkv"], h, col_mask=qkv_mask)
    ci = qkv.shape[-1] // 3          # may be < C after structured pruning
    qkv = qkv.reshape(B, H * W, 3, ci)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = ops.attention(q[:, :, None, :], k[:, :, None, :],
                        v[:, :, None, :], causal=False)[:, :, 0, :]
    out = out.reshape(B, H, W, ci)
    return x + ops.conv(p["proj"], out, row_mask=mask)


def upsample2x(h: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NHWC (``jax.image.resize`` "nearest")."""
    return h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------

def apply_unet(params: Params, cfg: ModelConfig, x: torch.Tensor,
               t: torch.Tensor, *,
               masks: Optional[Dict[str, Any]] = None,
               clients: Optional[int] = None) -> torch.Tensor:
    """Noise prediction eps(x_t, t).  x: (B, H, W, C) NHWC; t: (B,)
    integer timesteps.  ``masks``: optional prune masks keyed by
    PruneGroup name (``make_masks`` output for ``unet_groups``), shared
    by every client.  ``clients=C``: stacked params (C, ...) and x, t of
    C * B rows, client after client (module docstring)."""
    lead = params["conv_in"]["w"].dim() - 4
    if (clients is not None) != bool(lead) or (clients is not None and (
            params["conv_in"]["w"].shape[0] != clients
            or x.shape[0] % clients)):
        raise ValueError(f"clients={clients} with conv_in weights "
                         f"{tuple(params['conv_in']['w'].shape)} and a batch "
                         f"of {x.shape[0]}")
    mk = (lambda *path: None) if masks is None else \
        (lambda *path: masks.get("/".join(map(str, path))))

    temb = sinusoidal_embedding(t, cfg.base_channels)
    temb = ops.dense(params["temb2"], F.silu(ops.dense(params["temb1"], temb)))

    h = ops.conv(params["conv_in"], x)
    skips = [h]
    for lvl, lvl_p in enumerate(params["down"]):
        for bi, blk in enumerate(lvl_p["blocks"]):
            h = apply_resblock(blk["res"], h, temb,
                               mask=mk("down", lvl, "blocks", bi, "res"))
            if "attn" in blk:
                h = apply_attnblock(blk["attn"], h,
                                    mask=mk("down", lvl, "blocks", bi, "attn"))
            skips.append(h)
        if "down" in lvl_p:
            h = ops.conv(lvl_p["down"], h, stride=2)
            skips.append(h)

    mid = params["mid"]
    h = apply_resblock(mid["res1"], h, temb, mask=mk("mid", "res1"))
    h = apply_attnblock(mid["attn"], h, mask=mk("mid", "attn"))
    h = apply_resblock(mid["res2"], h, temb, mask=mk("mid", "res2"))

    for lvl, lvl_p in enumerate(params["up"]):
        for bi, blk in enumerate(lvl_p["blocks"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = apply_resblock(blk["res"], h, temb,
                               mask=mk("up", lvl, "blocks", bi, "res"))
            if "attn" in blk:
                h = apply_attnblock(blk["attn"], h,
                                    mask=mk("up", lvl, "blocks", bi, "attn"))
        if "up" in lvl_p:
            h = ops.conv(lvl_p["up"], upsample2x(h))

    h = F.silu(group_norm(h, params["norm_out"]["scale"],
                          params["norm_out"]["bias"]))
    return ops.conv(params["conv_out"], h)
