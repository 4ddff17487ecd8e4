"""Shared model building blocks (``repro/models/common.py``): GroupNorm
and the sinusoidal timestep embedding for the U-Net; RMSNorm, RoPE,
soft-capping, activations and initializers for the decoder stack."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initializers: the reference's shapes and scales, drawn in fp32 from a
# torch.Generator (on the device the tensors are made on) and then cast
# ---------------------------------------------------------------------------

def normal(generator: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device)
            * std).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: float = 1.0,
               device="cpu") -> torch.Tensor:
    return normal(generator, (in_dim, out_dim), scale / in_dim ** 0.5,
                  dtype, device)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    return normal(generator, (vocab, dim), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# decoder ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)``: the mean of squares
    in fp32, the rest in x's dtype (the reference's ``_rms_core``)."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S).  The angles and their
    cos/sin in fp32, the rotation in x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style soft-capping; ``cap <= 0`` leaves x alone."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


def activation_fn(name: str):
    """The FFN activation; the reference's relu and relu2 wait for the
    configs that use them (ROADMAP A.13)."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }[name]


# ---------------------------------------------------------------------------
# U-Net ops
# ---------------------------------------------------------------------------


def num_norm_groups(c: int, num_groups: int = 32) -> int:
    """``min(num_groups, c)``, lowered until it divides ``c`` (144
    channels after pruning give 24 groups)."""
    g = min(num_groups, c)
    while c % g != 0:
        g -= 1
    return g


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC, statistics in fp32, output in x's dtype.
    Stacked affine (C, c): client c's scale and bias apply to its share
    of the batch axis (the clients one after another)."""
    dtype = x.dtype
    n, h, w, c = x.shape
    g = num_norm_groups(c, num_groups)
    xg = x.float().reshape(n, h, w, g, c // g)
    var, mu = torch.var_mean(xg, dim=(1, 2, 4), keepdim=True,
                             correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    if scale.dim() == 1:
        y = xg.reshape(n, h, w, c) * scale + bias
    else:
        C = scale.shape[0]
        y = (xg.reshape(C, n // C, h, w, c) * scale[:, None, None, None]
             + bias[:, None, None, None]).reshape(n, h, w, c)
    return y.to(dtype)


def sinusoidal_embedding(t: torch.Tensor, dim: int,
                         max_period: float = 10000.0) -> torch.Tensor:
    """Timestep embedding. t: (B,) -> (B, dim) float32."""
    half = dim // 2
    # every step in float32, in the reference's order
    # (filled on the device: a host scalar's upload would block the host)
    log_p = torch.log(torch.full((), max_period, dtype=torch.float32,
                                 device=t.device))
    freqs = torch.exp(-log_p * torch.arange(half, dtype=torch.float32,
                                            device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
