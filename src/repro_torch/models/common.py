"""Shared U-Net building blocks (``repro/models/common.py``): GroupNorm
over NHWC activations and the sinusoidal timestep embedding."""
from __future__ import annotations

import torch


def num_norm_groups(c: int, num_groups: int = 32) -> int:
    """``min(num_groups, c)``, lowered until it divides ``c`` (144
    channels after pruning give 24 groups)."""
    g = min(num_groups, c)
    while c % g != 0:
        g -= 1
    return g


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC, statistics in fp32, output in x's dtype."""
    dtype = x.dtype
    n, h, w, c = x.shape
    g = num_norm_groups(c, num_groups)
    xg = x.float().reshape(n, h, w, g, c // g)
    var, mu = torch.var_mean(xg, dim=(1, 2, 4), keepdim=True,
                             correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    y = xg.reshape(n, h, w, c) * scale + bias
    return y.to(dtype)


def sinusoidal_embedding(t: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """Timestep embedding. t: (B,) -> (B, dim) float32."""
    half = dim // 2
    # every step in float32, in the reference's order
    log_p = torch.log(torch.tensor(max_period, dtype=torch.float32,
                                   device=t.device))
    freqs = torch.exp(-log_p * torch.arange(half, dtype=torch.float32,
                                            device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
