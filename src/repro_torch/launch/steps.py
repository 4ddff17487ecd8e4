"""Step builders (``repro/launch/steps.py``): train, optimizer init,
prefill and greedy decode.

Each builder closes over a ModelConfig and returns a plain function that
runs eagerly (there is no ``jit`` to hand it to); what runs where
follows the tensors' device.  The train step consumes its inputs, as a
step jitted with ``donate_argnums`` does: it updates params and
optimizer state in place and returns them.  At full width that is what
fits: bf16 params, their fp32 master, two fp32 moments and bf16 grads
take 16 B a param, and a functional update would hold another 14 B a
param (new params, master and moments) beside the old ones.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model
from repro_torch.optim import adam_init, adam_update_
from repro_torch.tree import tree_leaves, tree_unflatten


def build_train_step(cfg: ModelConfig, *, lr: float = 3e-4,
                     remat: bool = True):
    """train_step(params, opt_state, batch, seed=0) -> (params, opt_state,
    loss).

    The loss and its gradient come from ``torch.autograd`` through
    ``model.loss_fn`` (``remat``: each pattern cycle and cross-entropy
    chunk recomputed in the backward, the reference's default); then
    :func:`adam_update_` updates ``params`` and ``opt_state`` in place,
    and the same objects are returned: the step consumes its inputs.
    The loss stays on the device (0-d fp32).  ``seed`` is the
    reference's argument for the loss's draws; the decoder's loss has
    none.  The reference's ``state_dtype`` (bf16 moments for its
    largest models on a mesh) is not ported: the moments are fp32.
    """
    def train_step(params, opt_state, batch, seed: int = 0):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = model.loss_fn(params, cfg, batch, remat=remat)
            # a leaf the loss does not read (a parallel block's ln2)
            # gets a zero gradient, as the reference's grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
        finally:
            for p in leaves:
                p.requires_grad_(False)
        adam_update_(tree_unflatten(params, grads), opt_state, params, lr=lr)
        return params, opt_state, loss.detach()
    return train_step


def build_opt_init(cfg: ModelConfig):
    """opt_init(params) -> AdamState: fp32 moments, and an fp32 master
    when the params are bf16 (``cfg.param_dtype``)."""
    use_master = cfg.param_dtype == "bfloat16"

    def opt_init(params):
        return adam_init(params, use_master=use_master)
    return opt_init


def build_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> last-token logits (B, V)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch)
    return prefill_step


def build_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens) -> (next_tokens (B, 1) int32,
    new cache): one greedy token against the decode cache, which is left
    as it was (``serve_requests`` decodes into a cache it owns
    instead)."""
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode(params, cache, cfg, tokens)
        return logits.argmax(dim=-1).to(torch.int32), new_cache
    return serve_step
