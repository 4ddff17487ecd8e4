"""Client-side local training (``repro/fl/client.py``; paper Alg. 2),
the FedPhD method: the DDPM loss plus, in sparse rounds, the Omega
group-lasso (Eq. 16), one Adam step with global-norm clip 1.0 per batch.

The fedprox, moon and scaffold variants of the reference are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.pruning import depth_lambdas, omega
from repro_torch.core.sh_score import label_distribution
from repro_torch.data.pipeline import ClientData
from repro_torch.models import model
from repro_torch.models.ops import cast_floats, compute_dtype
from repro_torch.optim import adam_init, adam_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_loss_fn(cfg: ModelConfig, fl: FLConfig, *, sparse: bool = False,
                 groups=None, prune_masks=None):
    """``loss_fn(params, batch, generator=None, *, clients=None, t=None,
    eps=None)``: the DDPM loss, plus Omega when ``sparse`` (and
    ``groups`` are given).  The one definition both round engines close
    over: the sequential step calls it on one client's params and batch
    (t and eps drawn from ``generator``), the vectorized engine on
    stacked params with ``clients=C`` and the round's pre-drawn t and
    eps, for the (C,) per-client losses.

    ``prune_masks`` (PruneGroup name -> 0/1 device row) switches the
    U-Net to the masked sparse-phase forward (masked GEMMs instead of
    pre-zeroed weights).  ``cfg.precision`` is the mixed-precision
    boundary: under bf16 the float params are cast here, inside the
    loss, so forward and backward run in bf16 while the gradients come
    back through the cast as fp32, for the fp32 params the optimizer
    holds."""
    lambdas = depth_lambdas(groups, fl.lambda0) if (sparse and groups) \
        else None
    dt = compute_dtype(cfg.precision)

    def loss_fn(params, batch, generator=None, *, clients=None, t=None,
                eps=None):
        if dt != torch.float32:
            params = cast_floats(params, dt)
        kw = {} if prune_masks is None else {"masks": prune_masks}
        if clients is not None:
            kw.update(clients=clients, t=t, eps=eps)
        # through the module attribute, so a caller can swap the loss
        loss = model.loss_fn(params, cfg, batch, generator, **kw)
        if lambdas is not None:
            loss = loss + omega(params, groups, lambdas, clients)
        return loss

    return loss_fn


def make_local_step(cfg: ModelConfig, fl: FLConfig, *, sparse: bool = False,
                    groups=None, lr: float = 2e-4):
    """``step(params, opt_state, batch, generator) -> (params, opt_state,
    loss)``: value and gradient of the loss, then Adam with clip 1.0.
    The loss comes back as a device scalar; nothing here syncs."""
    loss_fn = make_loss_fn(cfg, fl, sparse=sparse, groups=groups)

    def step(params, opt_state, batch, generator):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, batch, generator)
        grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        params, opt_state = adam_update(grads, opt_state, params, lr=lr,
                                        grad_clip=1.0)
        return params, opt_state, loss.detach()

    return step


@dataclasses.dataclass
class Client:
    """One federated client: local data and its label distribution q_n."""
    cid: int
    data: ClientData
    num_classes: int

    def __post_init__(self):
        self.q_n = label_distribution(self.data.labels, self.num_classes)

    @property
    def n_samples(self) -> int:
        return len(self.data)


def run_local(step_fn, params, client: Client, *, epochs: int,
              generator: torch.Generator, opt_state=None,
              max_steps: Optional[int] = None,
              step_seconds: Optional[List[float]] = None):
    """Run E local epochs (Alg. 2).  Returns (params, opt_state, mean
    loss).

    Each step ends in the loss's host sync.  ``max_steps`` caps the
    executed steps; the epochs are still drained, so the shuffle stream
    advances as in a full round.  ``step_seconds``, when given, receives
    each executed step's host time, from the batch's upload to that
    sync."""
    if opt_state is None:
        opt_state = adam_init(params)
    device = tree_leaves(params)[0].device
    losses = []
    for _ in range(epochs):
        for batch in client.data.epoch():
            if max_steps is not None and len(losses) >= max_steps:
                continue
            t0 = time.perf_counter()
            tb = {k: torch.as_tensor(v, device=device)
                  for k, v in batch.items()}
            params, opt_state, loss = step_fn(params, opt_state, tb,
                                              generator)
            losses.append(float(loss))
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
    return params, opt_state, float(np.mean(losses)) if losses else 0.0
