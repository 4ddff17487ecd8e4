"""Client-side local training (``repro/fl/client.py``; paper Alg. 2) and
the baselines' variants of it.  One Adam step with global-norm clip 1.0
per batch, on a loss composed from the DDPM loss (Eq. 6) plus, by
method:

  - FedPhD sparse rounds: + Omega(G, k) group-lasso (Eq. 16);
  - FedProx:              + mu/2 ||theta - theta_global||^2;
  - MOON:                 + mu x the model-contrastive term on features;
  - SCAFFOLD:             the gradient corrected to g - c_i + c.

The method's anchors (``ctx``: ``global_params``, ``prev_params``,
``c_local``, ``c_global``) are constants: gradients flow into the
trained params only, as the reference's ``value_and_grad`` of
``params``.  The reference draws MOON's feature noise from
``fold_in(rng, 1)``, which the port cannot reproduce: the port draws it
from the step's generator right after the DDPM draws (or takes it as
``feat_eps``), and the vectorized engine's ``draw_round`` draws it in
that order too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.pruning import depth_lambdas, omega
from repro_torch.core.sh_score import label_distribution
from repro_torch.data.pipeline import ClientData
from repro_torch.diffusion.ddpm import q_sample
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.models import model
from repro_torch.models import transformer as tfm
from repro_torch.models.ops import cast_floats, compute_dtype
from repro_torch.models.unet import apply_unet
from repro_torch.optim import adam_init, adam_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def tree_sq_dist(a, b, clients: Optional[int] = None):
    """sum ||a - b||^2 over the leaves, in fp32; ``clients=C``: ``a``
    stacked (C, ...) against one ``b``, the (C,) per-client sums."""
    def leaf(x, y):
        d = torch.square(x.float() - y.float())
        return torch.sum(d) if clients is None \
            else torch.sum(d.reshape(clients, -1), dim=1)
    return sum(leaf(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def model_features(params, cfg: ModelConfig, inputs, eps=None, *,
                   clients: Optional[int] = None):
    """MOON's representation.  A U-Net's: its noise prediction at the
    fixed mid-schedule t = T // 2 for the images ``inputs`` noised by
    ``eps``, flattened per image (the reference's choice: MOON's
    penultimate layer has no counterpart in an eps-predictor);
    ``clients=C``: stacked params, C clients' images one after another.
    A transformer's: the mean over the sequence of ``forward``'s hidden
    states for the token batch ``inputs`` (``eps`` unused; no client
    axis)."""
    if cfg.arch_type != "unet":
        if clients is not None:
            raise ValueError(f"clients={clients}: the client axis stacks "
                             f"U-Net parameters only")
        hidden, _ = tfm.forward(params, cfg, inputs)
        return torch.mean(hidden, dim=1)
    sched = linear_schedule(cfg.diffusion_steps, device=inputs.device)
    B = inputs.shape[0]
    t = torch.full((B,), cfg.diffusion_steps // 2, dtype=torch.int64,
                   device=inputs.device)
    pred = apply_unet(params, cfg, q_sample(sched, inputs, t, eps), t,
                      clients=clients)
    return pred.reshape(B, -1)


def _cosine(a, b):
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) + 1e-8
    return num / den


def moon_term(params, ctx, cfg: ModelConfig, images, eps, tau: float,
              clients: Optional[int] = None):
    """MOON's contrastive term -mean(sim_g - logaddexp(sim_g, sim_p)),
    (C,) with ``clients=C``.  Only the trained model's features carry a
    gradient; the global model's are one unstacked forward over all the
    rows (never C copies of it), the previous models' a stacked one."""
    z = model_features(params, cfg, images, eps, clients=clients)
    with torch.no_grad():
        z_g = model_features(ctx["global_params"], cfg, images, eps)
        z_p = model_features(ctx["prev_params"], cfg, images, eps,
                             clients=clients)
    sim_g = _cosine(z, z_g) / tau
    sim_p = _cosine(z, z_p) / tau
    con = sim_g - torch.logaddexp(sim_g, sim_p)
    if clients is None:
        return -torch.mean(con)
    return -torch.mean(con.reshape(clients, -1), dim=1)


def make_loss_fn(cfg: ModelConfig, fl: FLConfig, *, method: str = "fedphd",
                 sparse: bool = False, groups=None, prune_masks=None):
    """``loss_fn(params, batch, generator=None, *, clients=None, t=None,
    eps=None, ctx=None, feat_eps=None)``: the DDPM loss, plus Omega when
    ``sparse`` (and ``groups`` are given), plus the method's term with
    its anchors from ``ctx``.  The one definition both round engines
    close over: the sequential step calls it on one client's params and
    batch (t, eps and MOON's ``feat_eps`` drawn from ``generator``, in
    that order), the vectorized engine on stacked params with
    ``clients=C`` and the round's pre-drawn t, eps and ``feat_eps``, for
    the (C,) per-client losses.

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
                eps=None, ctx=None, feat_eps=None):
        if dt != torch.float32:
            params = cast_floats(params, dt)
        kw = {} if prune_masks is None else {"masks": prune_masks}
        if clients is not None:
            kw["clients"] = clients
        if t is not None:
            kw.update(t=t, eps=eps)
        # through the module attribute, so a caller can swap the loss
        loss = model.loss_fn(params, cfg, batch, generator, **kw)
        if lambdas is not None:
            loss = loss + omega(params, groups, lambdas, clients)
        if method == "fedprox":
            loss = loss + 0.5 * fl.fedprox_mu * tree_sq_dist(
                params, ctx["global_params"], clients)
        if method == "moon":
            images = batch["images"]
            if feat_eps is None:
                feat_eps = torch.randn(images.shape, generator=generator,
                                       device=images.device,
                                       dtype=images.dtype)
            loss = loss + fl.moon_mu * moon_term(
                params, ctx, cfg, images, feat_eps, fl.moon_tau, clients)
        return loss

    return loss_fn


def scaffold_correction(grads, ctx):
    """SCAFFOLD's variance-reduced gradient g - c_i + c (Karimireddy et
    al.); stacked grads and c_i rows take the one c broadcast."""
    return tree_map(lambda g, ci, c: g - ci + c, grads, ctx["c_local"],
                    ctx["c_global"])


def scaffold_update(c_local, c_global, start, trained, scale):
    """SCAFFOLD's new control variate c_i+ = c_i - c + scale (x - y_i), x
    the client's start model and y_i its trained one, in fp32.  ``scale``
    is 1 / (K lr) for K local steps: a float, or a (C,) tensor for the
    stacked rows of C clients (``start`` then one model or C rows)."""
    def leaf(ci, c, x, y):
        s = scale.reshape((-1,) + (1,) * (y.dim() - 1)) \
            if isinstance(scale, torch.Tensor) else scale
        return ci - c + s * (x.float() - y.float())
    return tree_map(leaf, c_local, c_global, start, trained)


def make_local_step(cfg: ModelConfig, fl: FLConfig, *, method: str = "fedphd",
                    sparse: bool = False, groups=None, lr: float = 2e-4,
                    prune_masks=None):
    """``step(params, opt_state, batch, generator, ctx=None) -> (params,
    opt_state, loss)``: value and gradient of the method's loss
    (:func:`make_loss_fn`), SCAFFOLD's correction, then Adam with clip
    1.0.  The loss comes back as a device scalar; nothing here syncs."""
    loss_fn = make_loss_fn(cfg, fl, method=method, sparse=sparse,
                           groups=groups, prune_masks=prune_masks)

    def step(params, opt_state, batch, generator, ctx=None):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, batch, generator, ctx=ctx)
        grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        if method == "scaffold":
            grads = scaffold_correction(grads, ctx)
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
              generator: torch.Generator,
              ctx: Optional[Dict[str, Any]] = None, opt_state=None,
              max_steps: Optional[int] = None,
              step_seconds: Optional[List[float]] = None):
    """Run E local epochs (Alg. 2).  Returns (params, opt_state, mean
    loss).  ``ctx``, the method's anchors, goes to every step.

    Each step ends in the loss's host sync.  ``max_steps`` caps the
    executed steps; the epochs are still drained, so the shuffle stream
    advances as in a full round.  ``step_seconds``, when given, receives
    each executed step's host time, from the batch's upload to that
    sync."""
    if opt_state is None:
        opt_state = adam_init(params)
    device = tree_leaves(params)[0].device
    extra = () if ctx is None else (ctx,)
    losses = []
    for _ in range(epochs):
        for batch in client.data.epoch():
            if max_steps is not None and len(losses) >= max_steps:
                continue
            t0 = time.perf_counter()
            tb = {k: torch.as_tensor(v, device=device)
                  for k, v in batch.items()}
            params, opt_state, loss = step_fn(params, opt_state, tb,
                                              generator, *extra)
            losses.append(float(loss))
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
    return params, opt_state, float(np.mean(losses)) if losses else 0.0
