"""Dense feed-forward (optionally gated) blocks (``repro/models/ffn.py``).
The projections are plain ``@``, as the reference leaves them to XLA."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation_fn, dense_init


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, *,
             glu: bool, bias: bool, dtype=torch.float32, device="cpu"):
    p = {"w_in": dense_init(generator, d_model, d_ff, dtype, device=device),
         "w_out": dense_init(generator, d_ff, d_model, dtype, device=device)}
    if glu:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype,
                                 device=device)
    if bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def apply_ffn(p, x: torch.Tensor, *, activation: str,
              glu: bool) -> torch.Tensor:
    act = activation_fn(activation)
    h = x @ p["w_in"]
    if "b_in" in p:
        h = h + p["b_in"]
    h = act(x @ p["w_gate"]) * h if glu else act(h)
    out = h @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out
