"""Adam over nested parameter trees (``repro/optim/adam.py``): fp32
moments, bias correction, an integer step, optional global-norm
clipping and an optional fp32 master copy of reduced-precision params
(``adam_init(use_master=True)``: the update runs on the master and the
params become its cast).  The reference's ``weight_decay`` and its
train step's bf16 moments (``state_dtype``) are not ported: no caller
of the port sets them.

One implementation, :func:`adam_update_`, updates ``params``, ``mu``,
``nu``, ``master`` and ``step`` in place, leaf by leaf, holding at most
a few fp32 temporaries of one leaf.  The LM train step calls it: at
full width a second copy of params, master and moments (14 B a param)
does not fit beside the first.  :func:`adam_update` is the reference's
functional form, which the FL trainers call: it clones params and state
and updates the clones, so it returns new objects and changes neither
input.

A stacked state (a (C,) ``step`` over (C, ...) leaves, the vectorized
round engine's C clients) is what the reference's ``vmap`` of
``adam_update`` computes: each client's own global-norm clip, step and
bias correction, with the same per-element formula, op for op.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar, or (C,) for C stacked clients
    mu: Any
    nu: Any
    master: Any = None        # fp32 copy of reduced-precision params


def adam_init(params, *, use_master: bool = False) -> AdamState:
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params) if use_master else None
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     master=master)


def adam_from_tree(t, device=None) -> Optional[AdamState]:
    """Rebuild an ``AdamState`` from a plain ``(step, mu, nu[, master])``
    tuple tree (a checkpoint's arrays: loading flattens NamedTuples to
    tuples), its leaves as tensors on ``device``."""
    if t is None:
        return None
    if isinstance(t, AdamState):
        return t
    step, mu, nu, *rest = tuple(t)
    master = rest[0] if rest else None
    to_dev = lambda x: tree_map(
        lambda a: torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(device), x)
    return AdamState(step=to_dev(step).to(torch.int32), mu=to_dev(mu),
                     nu=to_dev(nu), master=to_dev(master))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                grad_clip: float = 0.0):
    """One Adam step.  Returns (new params, new state): clones of the
    inputs, updated by :func:`adam_update_`."""
    params, state = tree_map(torch.clone, (params, state))
    adam_update_(grads, state, params, lr=lr, b1=b1, b2=b2, eps=eps,
                 grad_clip=grad_clip)
    return params, state


@torch.no_grad()
def adam_update_(grads, state: AdamState, params, *, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 0.0) -> None:
    """One Adam step in place: ``params``, ``state.mu``, ``.nu``,
    ``.master`` and ``.step`` hold the new values after the call.  With
    a master copy the update runs on the fp32 master and the params
    become its cast to their dtype.  A stacked state updates each
    client's rows as their own Adam step (module docstring)."""
    stacked = state.step.dim() == 1

    def bcast(v, like):
        """A per-client (C,) vector shaped to broadcast over ``like``'s
        client axis; a scalar as it is."""
        return v.reshape(v.shape + (1,) * (like.dim() - 1)) if stacked else v

    scale = None
    if grad_clip > 0.0:
        if stacked:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()).reshape(
                g.shape[0], -1), dim=1) for g in tree_leaves(grads)))
        else:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    bc1 = 1 - b1 ** state.step.float()
    bc2 = 1 - b2 ** state.step.float()

    def upd(p, g, m, v, pm=None):
        # fp32 whatever the grads' dtype, as jnp promotes bf16 * f32
        g = g.float() * bcast(scale, g) if scale is not None else g.float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        del g
        delta = m.div(bcast(bc1, m)).div_(
            v.div(bcast(bc2, v)).sqrt_().add_(eps))
        src = pm if pm is not None else p.float()
        src.sub_(delta.mul_(lr))
        del delta
        if src is not p:
            p.copy_(src)

    # matched by key, not by leaf order: a state built from one tree may
    # meet params whose dicts were rebuilt with their keys in another order
    tree_map(upd, params, grads, state.mu, state.nu,
             *(() if state.master is None else (state.master,)))
