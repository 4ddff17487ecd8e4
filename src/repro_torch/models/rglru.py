"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU + output gate
(``repro/models/rglru.py``).

A full sequence runs the diagonal linear recurrence h_t = a_t h_{t-1} +
b_t through the hand-written scan kernel
(:func:`repro_torch.kernels.rglru_scan.ops.rglru_scan`), where the
reference runs ``lax.associative_scan``; decode carries (h, conv window)
state and takes one step in plain tensor ops, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.common import dense_init, normal

_C = 8.0  # RG-LRU temperature


def init_rglru(generator: torch.Generator, d_model: int, lru_width: int,
               conv_width: int, dtype=torch.float32, device="cpu"):
    W = lru_width

    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    def zeros():
        return torch.zeros((W,), dtype=dtype, device=device)

    # Lambda parametrized so a = exp(-c*softplus(L)) starts near 0.9..0.999
    log_lambda = torch.rand((W,), generator=generator, device=device) \
        * 3.3 - 4.3
    return {
        "w_x": dense(d_model, W),                 # recurrent branch in
        "w_y": dense(d_model, W),                 # gate branch in
        "conv_w": normal(generator, (conv_width, W), 0.02, dtype, device),
        "conv_b": zeros(),
        "w_a": dense(W, W),                       # recurrence gate
        "b_a": zeros(),
        "w_i": dense(W, W),                       # input gate
        "b_i": zeros(),
        "log_lambda": log_lambda.float(),
        "w_out": dense(W, d_model),
    }


def _gates(p, xc: torch.Tensor):
    """RG-LRU gates from the conv output xc (..., W): a and b in fp32."""
    r = torch.sigmoid(xc @ p["w_a"] + p["b_a"]).float()
    i = torch.sigmoid(xc @ p["w_i"] + p["b_i"]).float()
    log_a = -_C * F.softplus(p["log_lambda"]) * r            # (..., W)
    a = torch.exp(log_a)
    gated_x = i * xc.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * gated_x
    return a, b


def _conv1d(p, x: torch.Tensor, conv_width: int) -> torch.Tensor:
    """Causal temporal conv via shifted adds.  x: (B, S, W)."""
    out = torch.zeros_like(x)
    S = x.shape[1]
    for i in range(conv_width):
        xi = x if i == 0 else F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + xi * p["conv_w"][conv_width - 1 - i]
    return out + p["conv_b"]


def apply_rglru(p, x: torch.Tensor, *, conv_width: int) -> torch.Tensor:
    """Full-sequence recurrent block.  x: (B, S, d) -> (B, S, d)."""
    xr = x @ p["w_x"]
    xc = _conv1d(p, xr, conv_width)
    a, b = _gates(p, xc)
    h = rglru_scan(a.contiguous(), b.contiguous())
    gate = F.gelu(x @ p["w_y"], approximate="tanh")
    return (h.to(x.dtype) * gate) @ p["w_out"]


def init_rglru_state(batch: int, lru_width: int, conv_width: int, dtype,
                     device="cpu"):
    return {
        "h": torch.zeros((batch, lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, conv_width - 1, lru_width), dtype=dtype,
                            device=device),
    }


def rglru_decode(p, x: torch.Tensor, state, *, conv_width: int):
    """Single-step decode.  x: (B, 1, d) -> (out (B, 1, d), new state)."""
    xr = (x @ p["w_x"])[:, 0]                                 # (B, W)
    window = torch.cat([state["conv"], xr[:, None, :]], dim=1)  # (B, cw, W)
    xc = torch.einsum("bcw,cw->bw", window, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, xc)
    h = a * state["h"] + b
    gate = F.gelu(x[:, 0] @ p["w_y"], approximate="tanh")
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out[:, None, :], {"h": h, "conv": window[:, 1:]}
