"""Adam over nested parameter trees (``repro/optim/adam.py``): fp32
moments, bias correction, an integer step and optional global-norm
clipping.  Functional, as the reference: :func:`adam_update` returns
new params and a new state and changes neither input.  The fp32-master
variant (``use_master``) and weight decay are not ported yet.

A stacked state (a (C,) ``step`` over (C, ...) leaves, the vectorized
round engine's C clients) is what the reference's ``vmap`` of
``adam_update`` computes: each client's own global-norm clip, step and
bias correction, with the same per-element formula, op for op.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar, or (C,) for C stacked clients
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
    """One Adam step.  Returns (new params, new state).  A stacked state
    updates each client's rows as their own Adam step (module
    docstring)."""
    stacked = state.step.dim() == 1

    def bcast(v, like):
        """A per-client (C,) vector shaped to broadcast over ``like``'s
        client axis; a scalar as it is."""
        return v.reshape(v.shape + (1,) * (like.dim() - 1)) if stacked else v

    if grad_clip > 0.0:
        if stacked:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()).reshape(
                g.shape[0], -1), dim=1) for g in tree_leaves(grads)))
        else:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * bcast(scale, g), grads)
    step = state.step + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                  state.nu, grads)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, m, v):
        delta = (m / bcast(bc1, m)) / (torch.sqrt(v / bcast(bc2, v)) + eps)
        return (p.float() - lr * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)
