"""The vectorized round engine (``repro/fl/engine.py``), FedPhD's method.

The sequential engine (:func:`repro_torch.fl.client.run_local` driven by
:mod:`repro_torch.core.hfl`) trains one client after another, one step
a batch, with a host sync per loss.  This engine trains all of a round's
C clients at once, as the reference's ``vmap(client)``/``scan(step)``
program does, with the client axis written out instead of ``vmap`` (the
kernels are ctypes launches, which ``torch.func.vmap`` cannot batch):

    clients  -> a leading (C,) axis on every parameter, Adam moment and
                batch leaf; one value-and-gradient of sum_c loss_c per
                step, whose GEMMs are client-batched launches of the
                matmul kernel and whose Omega is one client-axis launch
                of the group-L2 kernel (the clients' parameters are
                disjoint, so each gets exactly its own gradient)
    batches  -> a Python loop over the round's (S,) steps
                (``stack_round`` pads ragged clients; a padded step keeps
                the client's old rows, so padding is a bitwise no-op)
    edge agg -> the fused (E, C) weight-matrix contraction per leaf

The per-client losses come back in one host sync a round.  The engine
closes over the same loss as the sequential step
(:func:`repro_torch.fl.client.make_loss_fn`), and the round's DDPM t and
eps are drawn before it runs (:func:`draw_round`) with exactly the
calls the sequential step makes, in its order, so both engines train on
the same draws and differ only in summation order.

Per-client Adam state can persist across rounds: a stacked (N, ...)
state (:func:`stacked_adam_init`) is gathered by the round's
participants (:func:`tree_gather`), passed in, and the engine's updated
rows are scattered back (:func:`tree_scatter`).
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.aggregation import weighted_average_stacked
from repro_torch.fl.client import make_loss_fn
from repro_torch.optim import AdamState, adam_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# stacked trees
# ---------------------------------------------------------------------------

def _stack(leaves):
    if isinstance(leaves[0], np.ndarray):
        return np.stack(leaves)
    return torch.stack(leaves)


def stack_trees(trees):
    """Stack congruent trees (torch or numpy leaves) on a leading member
    axis."""
    return tree_map(lambda *leaves: _stack(leaves), *trees)


def unstack_tree(stacked, n: int):
    """Inverse of :func:`stack_trees`: ``n`` per-member trees."""
    return [tree_map(lambda leaf, _i=i: leaf[_i], stacked) for i in range(n)]


def tree_gather(stacked, idx):
    """Rows ``idx`` of every leaf's leading axis, as new arrays (a scalar
    ``idx`` drops the axis).  Numpy leaves (the host store) gather on the
    host, so only the gathered rows move to the device later; torch
    leaves gather on their device."""
    np_idx = np.asarray(idx)

    def take(leaf):
        if isinstance(leaf, np.ndarray):
            return leaf[np_idx]
        if np_idx.ndim == 0:
            return leaf[int(np_idx)].clone()
        return leaf[torch.from_numpy(np_idx).to(leaf.device)]
    return tree_map(take, stacked)


def tree_scatter(stacked, idx, rows):
    """Write ``rows`` into every leaf of ``stacked`` at ``idx`` on the
    leading axis, in place, and return ``stacked``.  With ``idx`` free of
    repeats (participants are drawn without replacement) this inverts
    :func:`tree_gather`: rows outside ``idx`` are untouched, and permuting
    ``(idx, rows)`` together changes nothing.  Numpy leaves take the rows
    to the host; torch leaves take them to the stack's device."""
    np_idx = np.asarray(idx)

    def put(leaf, r):
        if isinstance(leaf, np.ndarray):
            leaf[np_idx] = r.detach().cpu().numpy() \
                if isinstance(r, torch.Tensor) else np.asarray(r)
        else:
            i = int(np_idx) if np_idx.ndim == 0 \
                else torch.from_numpy(np_idx).to(leaf.device)
            leaf[i] = torch.as_tensor(r).to(leaf.device)
        return leaf
    return tree_map(put, stacked, rows)


STORES = ("auto", "device", "host")


def resolve_store(store: str, n_clients: int,
                  n_participants: Optional[int] = None) -> str:
    """``"device"`` or ``"host"`` for a stacked per-client state.  A
    population run (thousands of clients, a few per round) must not hold
    N model copies in device memory, so ``"auto"`` picks the host (numpy
    leaves; only the round's rows move) when N >= 8 C and N >= 256;
    explicit ``"device"``/``"host"`` always win."""
    if store not in STORES:
        raise ValueError(f"unknown state store {store!r}; expected one "
                         f"of {STORES}")
    if store != "auto":
        return store
    c = max(int(n_participants or n_clients), 1)
    return "host" if (n_clients >= 8 * c and n_clients >= 256) else "device"


def stacked_zeros(tree, n: int, *, dtype=None, host: bool = False):
    """A zero (n, ...) stack congruent with ``tree``: numpy leaves on the
    host, else torch leaves on each leaf's device.  ``dtype`` (a torch
    dtype) overrides the leaves' dtypes."""
    if host:
        return tree_map(lambda p: np.zeros(
            (n,) + tuple(p.shape),
            _np_dtype(dtype or p.dtype)), tree)
    return tree_map(lambda p: torch.zeros((n,) + tuple(p.shape),
                                          dtype=dtype or p.dtype,
                                          device=p.device), tree)


def _np_dtype(dt: torch.dtype):
    return torch.empty((), dtype=dt).numpy().dtype


def store_tree(tree, store: str, device=None):
    """``tree`` moved into ``store``: ``"host"`` gives numpy leaves,
    anything else torch leaves on ``device``."""
    if tree is None:
        return None
    if store == "host":
        return tree_map(lambda x: x.detach().cpu().numpy()
                        if isinstance(x, torch.Tensor) else np.asarray(x),
                        tree)
    return tree_map(lambda x: torch.as_tensor(x).to(device), tree)


def stacked_adam_init(params, n: int, *, host: bool = False) -> AdamState:
    """Adam state for ``n`` persistent clients: every moment leaf gains a
    leading (n,) axis and the step becomes an (n,) int32 vector.
    ``host=True`` keeps it as numpy (:func:`resolve_store`)."""
    return AdamState(
        step=np.zeros((n,), np.int32) if host else torch.zeros(
            (n,), dtype=torch.int32, device=tree_leaves(params)[0].device),
        mu=stacked_zeros(params, n, dtype=torch.float32, host=host),
        nu=stacked_zeros(params, n, dtype=torch.float32, host=host))


def adam_stack_from_tree(t, store: str = "device",
                         device=None) -> Optional[AdamState]:
    """A stacked AdamState rebuilt in ``store`` from its ``(step, mu,
    nu)`` leaves (a checkpoint's arrays)."""
    if t is None:
        return None
    step, mu, nu = tuple(t)[:3]
    return store_tree(AdamState(step=step, mu=mu, nu=nu), store, device)


# ---------------------------------------------------------------------------
# the round's draws
# ---------------------------------------------------------------------------

def draw_round(generator: torch.Generator, valid: np.ndarray,
               image_shape, num_steps: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DDPM t (C, S, B) and eps (C, S, B, H, W, ch) of a round,
    client after client and, within a client, step after step: for each
    real step the calls the sequential step's ``ddpm_loss`` makes,
    ``torch.randint(0, T, (B,))`` then ``torch.randn((B, H, W, ch))``,
    so the generator yields the same numbers in the same order as in a
    sequential round.  Padded steps draw nothing and get zeros (their
    result is dropped).  One call per step, never one large draw: the
    generator's state advances per call, so one (S, B, ...) draw gives
    other numbers."""
    B = image_shape[0]
    ts, epss = [], []
    zt = torch.zeros((B,), dtype=torch.int64, device=device)
    ze = torch.zeros(tuple(image_shape), dtype=torch.float32, device=device)
    for row in valid:
        for ok in row:
            if ok:
                ts.append(torch.randint(0, num_steps, (B,),
                                        generator=generator, device=device))
                epss.append(torch.randn(tuple(image_shape),
                                        generator=generator, device=device,
                                        dtype=torch.float32))
            else:
                ts.append(zt)
                epss.append(ze)
    C, S = valid.shape
    return (torch.stack(ts).reshape((C, S, B)),
            torch.stack(epss).reshape((C, S) + tuple(image_shape)))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def make_train_one(loss_fn, *, lr: float = 2e-4):
    """The C clients' local rounds, one batched step at a time.

    ``train_one(params, opt_state, batches, valid, draws)`` ->
    ``(params, opt_state, losses)``: ``params`` and ``opt_state`` stacked
    (C, ...) (a (C,) Adam step), ``batches`` leaves (C, S, B, ...) on the
    device, ``valid`` the host (C, S) bool mask, ``draws`` the round's
    ``(t, eps)`` (:func:`draw_round`).  ``losses`` is the (C,) float64
    mean loss of each client's real steps, from the round's one host
    sync.  ``loss_fn(params, batch, None, clients=C, t=, eps=)`` gives
    the (C,) losses of one step.  A step where any client is padded
    keeps that client's params, moments and step as they were
    (``torch.where`` on the client axis): padding is a bitwise no-op.
    A step with no padding selects nothing.  (The reference's ``masked``
    flag picks one of two static XLA programs; this loop reads the mask
    at every step, so it needs no flag.)"""
    def train_one(params, opt_state, batches, valid, draws):
        C, S = valid.shape
        t_all, eps_all = draws
        device = t_all.device
        step_losses = []
        for s in range(S):
            batch = {k: v[:, s].reshape((-1,) + tuple(v.shape[3:]))
                     for k, v in batches.items()}
            p = tree_map(lambda x: x.detach().requires_grad_(), params)
            leaves = tree_leaves(p)
            losses = loss_fn(p, batch, None, clients=C,
                             t=t_all[:, s].reshape(-1),
                             eps=eps_all[:, s].reshape(
                                 (-1,) + tuple(eps_all.shape[3:])))
            grads = tree_unflatten(p, torch.autograd.grad(losses.sum(),
                                                          leaves))
            new_p, new_o = adam_update(grads, opt_state, params, lr=lr,
                                       grad_clip=1.0)
            if not valid[:, s].all():
                keep = torch.from_numpy(valid[:, s]).to(device)

                def sel(new, old):
                    k = keep.reshape((C,) + (1,) * (new.dim() - 1))
                    return torch.where(k, new, old)
                new_p = tree_map(sel, new_p, params)
                new_o = tree_map(sel, new_o, opt_state)
            params, opt_state = new_p, new_o
            step_losses.append(losses.detach())
        # the round's one host sync; each client's mean over its real
        # steps, as the sequential engine takes it
        per_step = torch.stack(step_losses, dim=1).cpu().double().numpy()
        losses = np.asarray([np.mean(row[ok]) if ok.any() else 0.0
                             for row, ok in zip(per_step, valid)])
        return params, opt_state, losses

    return train_one


def make_round_engine(cfg: ModelConfig, fl: FLConfig, *,
                      sparse: bool = False, groups=None, lr: float = 2e-4,
                      prune_masks=None):
    """The vectorized round for FedPhD's clients.

    ``sparse`` with ``groups`` adds Omega to the loss (one client-axis
    group-L2 launch a step); ``prune_masks`` (PruneGroup name -> 0/1
    device row, shared by every client) switches the U-Net to the masked
    sparse-phase forward.

    Returns ``engine(edge_params, edge_idx, batches, valid, draws, w_mat,
    opt_states=None)`` where

      edge_params: tree, leaves (E, ...): each edge server's model
      edge_idx:    (C,) int: the edge each client starts from
      batches:     tree, leaves (C, S, B, ...) on the device
                   (``stack_round``)
      valid:       (C, S) host bool mask of real steps
      draws:       the round's (t, eps) (:func:`draw_round`)
      w_mat:       (E, C) float32 normalized per-edge aggregation rows
      opt_states:  stacked per-client Adam rows; None starts every
                   client's Adam from zeros

    and the result is a dict: ``"agg"``, the edge-aggregated models with a
    leading (E,) axis (fp32 sums, integer leaves rounded); ``"losses"``,
    the (C,) host mean losses; ``"opt"``, the updated Adam rows (when
    ``opt_states`` was given)."""
    loss_fn = make_loss_fn(cfg, fl, sparse=sparse, groups=groups,
                           prune_masks=prune_masks)
    train_one = make_train_one(loss_fn, lr=lr)

    def engine(edge_params, edge_idx, batches, valid, draws, w_mat,
               opt_states=None):
        device = tree_leaves(edge_params)[0].device
        idx = torch.as_tensor(np.asarray(edge_idx), device=device)
        start = tree_map(lambda leaf: leaf[idx], edge_params)
        C = valid.shape[0]
        if opt_states is not None:
            opt0 = opt_states
        else:                           # every client starts from zeros
            zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)
            opt0 = AdamState(
                step=torch.zeros((C,), dtype=torch.int32, device=device),
                mu=tree_map(zeros, start), nu=tree_map(zeros, start))
        trained, opt_out, losses = train_one(start, opt0, batches, valid,
                                             draws)
        out = {"agg": weighted_average_stacked(trained, w_mat),
               "losses": losses}
        if opt_states is not None:
            out["opt"] = opt_out
        return out

    return engine


def uniform_batch_shape(clients) -> Optional[tuple]:
    """The clients' common (B, H, W, ch) batch shape, or None if they
    differ (a client with fewer images than the batch size): the
    vectorized engine needs one."""
    shapes = {(c.data.batch_size,) + tuple(c.data.images.shape[1:])
              for c in clients}
    return shapes.pop() if len(shapes) == 1 else None


def route_engine(engine: str, strict: bool, round_clients,
                 warned: bool) -> Tuple[bool, bool]:
    """``(use_vectorized, warned)`` for one round.  Clients of ragged
    batch shapes fall back to the sequential engine, with a warning once
    per trainer (``warned`` carries that across its rounds); an
    explicitly requested (strict) ``"vectorized"`` raises instead."""
    if engine == "sequential":
        return False, warned
    uniform = uniform_batch_shape(round_clients) is not None
    if not uniform:
        if engine == "vectorized" and strict:
            raise ValueError("vectorized engine needs a uniform client "
                             "batch shape; use engine='auto' or "
                             "'sequential' for ragged clients")
        if not warned:
            warnings.warn(f"ragged client batch shapes: FedPhD "
                          f"(engine={engine}) falling back to the "
                          "sequential round engine", RuntimeWarning)
            warned = True
    return uniform, warned
