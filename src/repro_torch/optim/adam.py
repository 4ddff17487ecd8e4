"""Adam over nested parameter trees (``repro/optim/adam.py``): fp32
moments, bias correction, an integer step and optional global-norm
clipping.  Functional, as the reference: :func:`adam_update` returns
new params and a new state and changes neither input.  The fp32-master
variant (``use_master``) and weight decay are not ported yet."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    mu: Any
    nu: Any


def adam_init(params) -> AdamState:
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                grad_clip: float = 0.0):
    """One Adam step.  Returns (new params, new state)."""
    if grad_clip > 0.0:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state.nu, grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m, v):
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return (p.float() - lr * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)
