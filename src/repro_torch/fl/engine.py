"""The vectorized round engine (``repro/fl/engine.py``), for FedPhD and
the flat baselines (FedAvg, FedProx, MOON, SCAFFOLD, FedDiffuse).

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
    ctx      -> the method's anchors (``CTX_AXES``: 0 = per-client
                (C, ...) rows, sliced with the chunk; None = one copy
                every client reads): FedProx's and MOON's global model,
                MOON's previous local models, SCAFFOLD's control
                variates, FedDiffuse's local (never sent) decoder rows
    edge agg -> the fused (E, C) weight-matrix contraction per leaf (the
                flat baselines are the E = 1 case)
    scaffold -> the c_i+ rows and the uniform mean of their change

A round's clients train in consecutive chunks of at most k clients
(:func:`client_chunk`: k from the config, the batch shape, the precision
and the card's total memory, so every run of one configuration makes
the same cut; k = C on the CPU).  Each chunk takes one client-batched
step a batch; the trained models land in one (C, ...) stack for the
(E, C) aggregation.

The per-client losses stay on the device: the engine returns their
(C,) means as a device tensor and syncs nothing, so a caller can
dispatch the next round before this one's losses reach the host (the
trainers' pipelined ``run()``).  The engine closes over the same loss
as the sequential step
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
from repro_torch.core.aggregation import (combine_leaf,
                                          weighted_average_stacked)
from repro_torch.device import host_to_device
from repro_torch.fl.client import (make_loss_fn, scaffold_correction,
                                   scaffold_update)
from repro_torch.fl.compress import ef_roundtrip_stacked
from repro_torch.optim import AdamState, adam_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# The axis of each method's ctx entries: 0 = per-client (C, ...) rows,
# None = one copy every client reads (the reference's vmap in_axes).
CTX_AXES = {
    "fedphd": {},
    "fedavg": {},
    "fedprox": {"global_params": None},
    "feddiffuse": {"local_params": 0},
    "moon": {"global_params": None, "prev_params": 0},
    "scaffold": {"c_local": 0, "c_global": None, "scale": 0},
}


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
        return leaf[host_to_device(np_idx, leaf.device)]
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
                else host_to_device(np_idx, leaf.device)
            leaf[i] = torch.as_tensor(r).to(leaf.device)
        return leaf
    return tree_map(put, stacked, rows)


def scatter_rows(stacked, ids, rows, mask):
    """Write the rows of the clients of ``mask`` into ``stacked`` at their
    ids: ``rows`` and ``ids`` hold one entry a client of the round, in
    the engine's order.  In place (:func:`tree_scatter`)."""
    if mask.any():
        pos = np.flatnonzero(mask)
        tree_scatter(stacked, np.asarray(ids)[pos],
                     rows if mask.all() else tree_gather(rows, pos))


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
    # host rows go up without blocking the host (a host store's round)
    return tree_map(lambda x: host_to_device(x, device)
                    if isinstance(x, np.ndarray) and device is not None
                    else torch.as_tensor(x).to(device), tree)


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
               image_shape, num_steps: int, device, *,
               features: bool = False) -> Tuple[torch.Tensor, ...]:
    """The DDPM t (C, S, B) and eps (C, S, B, H, W, ch) of a round,
    client after client and, within a client, step after step: for each
    real step the calls the sequential step's ``ddpm_loss`` makes,
    ``torch.randint(0, T, (B,))`` then ``torch.randn((B, H, W, ch))``,
    so the generator yields the same numbers in the same order as in a
    sequential round.  ``features`` (MOON) adds a third (C, S, B, H, W,
    ch) draw, the feature noise the sequential MOON step draws right
    after its DDPM draws.  Padded steps draw nothing and get zeros
    (their result is dropped).  One call per step, never one large draw:
    the generator's state advances per call, so one (S, B, ...) draw
    gives other numbers."""
    B = image_shape[0]
    shape = tuple(image_shape)
    out = ([], [], []) if features else ([], [])
    zt = torch.zeros((B,), dtype=torch.int64, device=device)
    ze = torch.zeros(shape, dtype=torch.float32, device=device)
    for row in valid:
        for ok in row:
            if not ok:
                out[0].append(zt)
                for lst in out[1:]:
                    lst.append(ze)
                continue
            out[0].append(torch.randint(0, num_steps, (B,),
                                        generator=generator, device=device))
            for lst in out[1:]:
                lst.append(torch.randn(shape, generator=generator,
                                       device=device, dtype=torch.float32))
    C, S = valid.shape
    return (torch.stack(out[0]).reshape((C, S, B)),) + tuple(
        torch.stack(lst).reshape((C, S) + shape) for lst in out[1:])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def make_train_one(loss_fn, *, method: str = "fedphd", lr: float = 2e-4):
    """The C clients' local rounds, one batched step at a time.

    ``train_one(params, opt_state, batches, valid, draws, ctx=None)`` ->
    ``(params, opt_state, losses)``: ``params`` and ``opt_state`` stacked
    (C, ...) (a (C,) Adam step), ``batches`` leaves (C, S, B, ...) on the
    device, ``valid`` the host (C, S) bool mask, ``draws`` the round's
    ``(t, eps)`` or, for MOON, ``(t, eps, feat_eps)`` (:func:`draw_round`),
    ``ctx`` the method's anchors, rows already the C clients'.
    ``losses`` is the (C,) float64 mean loss of each client's real
    steps, from the round's one host sync.  ``loss_fn(params, batch,
    None, clients=C, t=, eps=)`` (with ``ctx=`` and ``feat_eps=`` where
    the method has them) gives the (C,) losses of one step; SCAFFOLD's
    gradients are corrected per client before Adam.  A step where any client is padded
    keeps that client's params, moments and step as they were
    (``torch.where`` on the client axis): padding is a bitwise no-op.
    A step with no padding selects nothing, and a step where no client
    has a real batch is not run.  (The reference's ``masked``
    flag picks one of two static XLA programs; this loop reads the mask
    at every step, so it needs no flag.)

    ``train_one.steps(start, batches, valid, draws, ctx=None)`` is the
    same loop
    without the sync, for a caller that trains several chunks of clients
    and syncs once (:func:`client_means`): ``start()`` returns the
    initial ``(params, opt_state)``, so that the loop holds the only
    reference to them and each step's inputs are freed as the next
    begins (held by a caller, they would add three model copies a
    client to every step after the first); it returns the (C, S) step
    losses on the device."""
    def steps(start, batches, valid, draws, ctx=None):
        params, opt_state = start()
        C, S = valid.shape
        device = draws[0].device
        # the mask on the device, uploaded once: a step with padding
        # selects on it
        mask = None if valid.all() else host_to_device(valid, device)
        # step s of every client, the clients' rows one after another
        at = lambda d, s: d[:, s].reshape((-1,) + tuple(d.shape[3:]))
        step_losses = []
        for s in range(S):
            if not valid[:, s].any():        # every client's budget spent
                step_losses.append(torch.zeros((C,), device=device))
                continue
            batch = {k: at(v, s) for k, v in batches.items()}
            kw = {} if ctx is None else {"ctx": ctx}
            if len(draws) > 2:
                kw["feat_eps"] = at(draws[2], s)
            p = tree_map(lambda x: x.detach().requires_grad_(), params)
            leaves = tree_leaves(p)
            losses = loss_fn(p, batch, None, clients=C,
                             t=at(draws[0], s), eps=at(draws[1], s),
                             **kw)
            grads = tree_unflatten(p, torch.autograd.grad(losses.sum(),
                                                          leaves))
            if method == "scaffold":
                grads = scaffold_correction(grads, ctx)
            new_p, new_o = adam_update(grads, opt_state, params, lr=lr,
                                       grad_clip=1.0)
            if not valid[:, s].all():
                keep = mask[:, s]

                def sel(new, old):
                    k = keep.reshape((C,) + (1,) * (new.dim() - 1))
                    return torch.where(k, new, old)
                new_p = tree_map(sel, new_p, params)
                new_o = tree_map(sel, new_o, opt_state)
            params, opt_state = new_p, new_o
            step_losses.append(losses.detach())
        return params, opt_state, torch.stack(step_losses, dim=1)

    def train_one(params, opt_state, batches, valid, draws, ctx=None):
        params, opt_state, per_step = steps(lambda: (params, opt_state),
                                            batches, valid, draws, ctx)
        return params, opt_state, client_means(per_step, valid)

    train_one.steps = steps
    return train_one


def client_means(per_step: torch.Tensor, valid: np.ndarray) -> np.ndarray:
    """The (C,) float64 mean of each client's real steps' losses, as the
    sequential engine takes it, from one host sync of the (C, S) device
    losses (:func:`device_means` is the same on the device)."""
    per_step = per_step.cpu().double().numpy()
    return np.asarray([np.mean(row[ok]) if ok.any() else 0.0
                       for row, ok in zip(per_step, valid)])


def device_means(per_step: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The (C,) float64 mean of each client's real steps' losses (0 for a
    client with none) on the device, with no sync: ``mask`` is the (C, S)
    bool mask of real steps on ``per_step``'s device."""
    x = torch.where(mask, per_step.double(), 0.0)
    n = mask.sum(dim=1)
    return torch.where(n > 0, x.sum(dim=1) / n.clamp(min=1), 0.0)


# ---------------------------------------------------------------------------
# client chunks: how many clients one batched step holds
# ---------------------------------------------------------------------------

# The memory model of one chunk, fitted to the vectorized engine's peak
# for one sparse step of full-width CIFAR10_UNET in fp32 at batch 32
# (chip_smoke.py's engine_memory line on an H100 80GB HBM3 at 700 W:
# 26.61 GB at C = 4, 52.85 at 8, 66.00 at 10, 79.18 at 12, so 6.57 GB a
# client and 0.32 GB besides).
#
# A client's state beside its activations, in copies of its fp32
# parameters: the parameters, their gradients, Adam's two moments, and
# the new parameters and moments a step writes before the old ones go.
STATE_COPIES = 8
# Bytes the backward keeps a sample, as a share of the activation
# elements :func:`unet_elems` counts times the compute
# dtype's size: 0.9 x 4 B x 48,671,232 elements x 32 + 8 x 143 MB is
# 6.75 GB a client, 2.6% above the 6.57 measured.
ACT_SHARE = 0.9
# Of the card's total memory, the share a round may plan to allocate:
# the CUDA context and the caching allocator's slack take the rest.
USABLE_SHARE = 0.9
_DTYPE_BYTES = {"fp32": 4, "bf16": 2}
# What a method adds to a round, beside FedPhD's: fp32 model copies per
# round client and per chunk client, and the chunk client's activations
# as a multiple of one forward's.  FedProx: the backward keeps
# x - global of every leaf (its one global model is the trainer's own,
# counted).  MOON: the round's prev_params rows; the trained model's
# feature forward keeps a second forward's activations, and the no-grad
# forwards of the global and previous models add their transients.
# SCAFFOLD: the c_local rows and the c_new stack; the corrected
# gradients beside the raw ones.  FedDiffuse: the decoder rows (counted
# as whole models).
METHOD_COPIES = {"fedphd": (0, 0, 1.0), "fedavg": (0, 0, 1.0),
                 "fedprox": (0, 1, 1.0), "moon": (1, 0, 2.2),
                 "scaffold": (2, 1, 1.0), "feddiffuse": (1, 0, 1.0)}
# the methods whose trained models outlive the round (MOON's previous
# models, FedDiffuse's decoders): the engine returns them as "trained"
KEEPS_TRAINED = ("moon", "feddiffuse")


def unet_elems(cfg: ModelConfig) -> Tuple[int, int]:
    """``(parameters, activation elements a sample)`` of ``cfg``'s dense
    U-Net, by walking
    :func:`repro_torch.models.unet.init_unet`'s structure.  The
    activation count sums, for every conv, its im2col operand and its
    output; for every GroupNorm and SiLU, input and output; for every
    attention block, its q, k, v and output and the S x S scores the
    backward recomputes; and the skip concatenations."""
    ch, temb = cfg.base_channels, 4 * cfg.base_channels
    n = {"p": ch * temb + temb + temb * temb + temb, "a": 0}

    def conv(k, cin, cout, hw):
        n["p"] += k * k * cin * cout + cout
        n["a"] += (k * k * cin + cout) * hw

    def norm(c, hw):
        n["p"] += 2 * c
        n["a"] += 2 * c * hw

    def res(cin, cout, hw):
        norm(cin, hw)
        conv(3, cin, cout, hw)
        n["p"] += temb * cout + cout
        norm(cout, hw)
        conv(3, cout, cout, hw)
        if cin != cout:
            conv(1, cin, cout, hw)
        n["a"] += cout * hw

    def attn(c, hw):
        norm(c, hw)
        conv(1, c, 3 * c, hw)
        conv(1, c, c, hw)
        n["a"] += 2 * c * hw + 2 * hw * hw

    r = cfg.image_size
    conv(3, cfg.in_channels, ch, r * r)
    chans, cur = [ch], ch
    for lvl, mult in enumerate(cfg.channel_mults):
        for _ in range(cfg.num_res_blocks):
            res(cur, ch * mult, r * r)
            cur = ch * mult
            if r in cfg.attn_resolutions:
                attn(cur, r * r)
            chans.append(cur)
        if lvl != len(cfg.channel_mults) - 1:
            r //= 2
            conv(3, cur, cur, r * r)
            chans.append(cur)
    res(cur, cur, r * r)
    attn(cur, r * r)
    res(cur, cur, r * r)
    for lvl, mult in reversed(list(enumerate(cfg.channel_mults))):
        for _ in range(cfg.num_res_blocks + 1):
            skip = chans.pop()
            n["a"] += (cur + skip) * r * r
            res(cur + skip, ch * mult, r * r)
            cur = ch * mult
            if r in cfg.attn_resolutions:
                attn(cur, r * r)
        if lvl != 0:
            r *= 2
            n["a"] += cur * r * r
            conv(3, cur, cur, r * r)
    norm(ch, r * r)
    conv(3, ch, cfg.in_channels, r * r)
    return n["p"], n["a"]


def round_bytes(cfg: ModelConfig, batch_shape, k: int, *, edges: int = 1,
                opt_rows: bool = False, method: str = "fedphd",
                stored: int = 0, quant: bool = False,
                late: bool = False) -> int:
    """The estimated peak bytes of a round whose images stack as
    ``batch_shape`` (C, S, B, H, W, ch), trained in chunks of ``k``
    clients: every client's fp32 model in the trained stack, the E edge
    models twice (the trainer's and the engine's stack) and the global
    model, the round's images and eps (and MOON's feature noise), with
    ``opt_rows`` the C clients' persistent Adam rows in and out, and
    ``stored`` fp32 model copies the trainer keeps across rounds (its
    (N, ...) method state on the card); the chunk's k clients' state and
    activations (module constants); and the method's own copies
    (``METHOD_COPIES``).  ``quant`` adds the C clients' error-feedback
    rows in and their new residuals out (the reconstructed models take
    the trained stack's place, beside it for MOON and FedDiffuse, which
    keep it); ``late`` the E edges' late-delta sums; either the chunk's
    start rows its deltas are taken from."""
    C, B = int(batch_shape[0]), int(batch_shape[2])
    params, acts = unet_elems(cfg)
    p_bytes = 4 * params
    per_round, per_chunk, act_mult = METHOD_COPIES[method]
    data = (3 if method == "moon" else 2) * 4 * int(np.prod(batch_shape))
    if quant:
        per_round += 2 + (method in KEEPS_TRAINED)
    if quant or late:
        per_chunk += 1          # the chunk's start rows, gathered
    models = 2 * edges + 1 + C + (4 * C if opt_rows else 0) \
        + per_round * C + stored + (edges if late else 0)
    fixed = models * p_bytes + data
    dtype = _DTYPE_BYTES[cfg.precision or "fp32"]
    per_client = (STATE_COPIES + per_chunk) * p_bytes \
        + act_mult * ACT_SHARE * dtype * B * acts
    return int(fixed + k * per_client)


def client_chunk(cfg: ModelConfig, batch_shape, total_memory: int, *,
                 edges: int = 1, opt_rows: bool = False,
                 method: str = "fedphd", stored: int = 0,
                 quant: bool = False, late: bool = False) -> int:
    """The chunk size k for a round whose images stack as ``batch_shape``
    (C, S, B, H, W, ch) on a card of ``total_memory`` bytes: the fewest
    chunks whose :func:`round_bytes` fits USABLE_SHARE of the card, cut
    as evenly as they go (C = 20 at a largest fit of 12 is 10 + 10), so
    every chunk runs one matmul plan and one group-L2 table.  It reads
    the card's total memory, never its free memory, so a resumed run
    makes the same cut.  Raises MemoryError, with the numbers, when one
    client does not fit."""
    C = int(batch_shape[0])
    budget = USABLE_SHARE * total_memory
    kw = dict(edges=edges, opt_rows=opt_rows, method=method, stored=stored,
              quant=quant, late=late)
    fits = [k for k in range(1, C + 1)
            if round_bytes(cfg, batch_shape, k, **kw) <= budget]
    if not fits:
        need = round_bytes(cfg, batch_shape, 1, **kw)
        raise MemoryError(
            f"one client of {cfg.name} at batch shape {tuple(batch_shape)}"
            f" ({cfg.precision or 'fp32'}) needs an estimated {need:,} "
            f"bytes with {C} clients' models kept; the card's "
            f"{total_memory:,} bytes allow {int(budget):,} "
            f"(USABLE_SHARE {USABLE_SHARE}); pass engine='sequential'")
    chunks = -(-C // max(fits))
    return -(-C // chunks)


def chunk_bounds(C: int, k: int):
    """``[(a, b), ...]``: C clients in ceil(C / k) consecutive chunks of
    sizes that differ by at most one (``np.array_split``'s cut)."""
    n = -(-C // k)
    sizes = [C // n + (i < C % n) for i in range(n)]
    ends = np.cumsum([0] + sizes)
    return [(int(a), int(b)) for a, b in zip(ends, ends[1:])]


def make_round_engine(cfg: ModelConfig, fl: FLConfig, *,
                      method: str = "fedphd", sparse: bool = False,
                      groups=None, lr: float = 2e-4, prune_masks=None,
                      max_clients: Optional[int] = None, stored: int = 0,
                      quant: str = "none"):
    """The vectorized round for ``method``'s clients.

    ``sparse`` with ``groups`` adds Omega to the loss (one client-axis
    group-L2 launch a step); ``prune_masks`` (PruneGroup name -> 0/1
    device row, shared by every client) switches the U-Net to the masked
    sparse-phase forward.

    ``quant`` ("none", "int8", "fp8": :mod:`repro_torch.fl.compress`)
    turns on the quantized uplink: given the clients' error-feedback rows
    (``err=``), the engine runs each client's delta through the
    quantize -> dequantize round trip, aggregates the reconstructed
    ``start + deq`` (what the edge decodes) and returns the new residual
    rows.  Late deltas and SCAFFOLD's variates stay fp32.

    Returns ``engine(edge_params, edge_idx, batches, valid, draws, w_mat,
    ctx=None, opt_states=None, w_late=None, err=None)`` where

      edge_params: tree, leaves (E, ...): each edge server's model (the
                   flat baselines: E = 1, the global model)
      edge_idx:    (C,) int: the edge each client starts from
      batches:     tree, leaves (C, S, B, ...) on the device
                   (``stack_round``)
      valid:       (C, S) host bool mask of real steps
      draws:       the round's (t, eps) or, for MOON, (t, eps, feat_eps)
                   (:func:`draw_round`)
      w_mat:       (E, C) float32 normalized per-edge aggregation rows
      ctx:         the method's anchors by ``CTX_AXES[method]``: (C, ...)
                   rows or one shared copy; FedDiffuse's
                   ``local_params`` rows replace the start's decoder
      opt_states:  stacked per-client Adam rows; None starts every
                   client's Adam from zeros
      w_late:      optional (E, C) float32 staleness rows over the late
                   clients' deltas (their shares of the round's samples,
                   unnormalized; their ``w_mat`` entries are zero)
      err:         (C, ...) fp32 error-feedback rows (with ``quant``)

    and the result is a dict: ``"agg"``, the edge-aggregated models with a
    leading (E,) axis (fp32 sums, integer leaves rounded); ``"losses"``,
    the (C,) float64 mean losses as a device tensor (:func:`device_means`:
    the engine syncs nothing, the caller syncs them); ``"opt"``, the
    updated Adam rows (when ``opt_states`` was given); ``"trained"``,
    the (C, ...) trained models (MOON, FedDiffuse); ``"late"``, the
    (E, ...) fp32 sums
    ``sum_c w_late[e, c] (trained_c - start_c)`` (with ``w_late``),
    added chunk after chunk; ``"err"``, the (C, ...) new residual rows
    (with ``quant``; the caller keeps only the on-time reporters'); and
    for SCAFFOLD ``"c_new"``, the (C, ...) c_i+ = c_i - c + scale_i (x -
    y_i) rows, with x the client's start model, and ``"dc_mean"``, the
    uniform mean of c_i+ - c_i.

    The clients train in chunks (:func:`client_chunk` on a CUDA device,
    all C at once on the CPU), the ctx rows sliced with them; ``stored``
    is the fp32 model copies the caller keeps on the card across rounds,
    which the chunk size leaves room for.  ``max_clients`` replaces that
    choice with chunks of at most ``max_clients`` (tests, and the memory
    probes of ``chip_smoke.py``)."""
    loss_fn = make_loss_fn(cfg, fl, method=method, sparse=sparse,
                           groups=groups, prune_masks=prune_masks)
    train_one = make_train_one(loss_fn, method=method, lr=lr)
    axes = CTX_AXES[method]

    def engine(edge_params, edge_idx, batches, valid, draws, w_mat,
               ctx=None, opt_states=None, w_late=None, err=None):
        ctx = ctx or {}
        device = tree_leaves(edge_params)[0].device
        C = valid.shape[0]
        quantized = quant != "none" and err is not None
        if max_clients is not None:
            k = min(max_clients, C)
        elif device.type == "cuda":
            k = client_chunk(
                cfg, tuple(batches["images"].shape),
                torch.cuda.get_device_properties(device).total_memory,
                edges=tree_leaves(edge_params)[0].shape[0],
                opt_rows=opt_states is not None, method=method,
                stored=stored, quant=quantized, late=w_late is not None)
        else:
            k = C
        wl = None if w_late is None else host_to_device(
            np.asarray(w_late, np.float32), device)
        bounds = chunk_bounds(C, k)
        edge_idx = np.asarray(edge_idx)
        # uploaded once for the round; each chunk slices its rows
        edge_idx_dev = host_to_device(edge_idx.astype(np.int64), device)
        local = ctx.get("local_params")
        step_losses, out, dc, late = [], {}, None, None

        def rows(tree, a, b):
            return tree_map(lambda x: x[a:b], tree)

        def start_rows(a, b):
            """The chunk's start models, read in place where they all
            start from one edge (the flat round), FedDiffuse's decoders
            from its local rows."""
            if len(set(edge_idx[a:b].tolist())) == 1:
                e = int(edge_idx[a])
                pick = lambda leaf: leaf[e:e + 1]
            else:
                idx = edge_idx_dev[a:b]
                pick = lambda leaf: leaf[idx]
            return {name: rows(local[name], a, b)
                    if local is not None and name in local else
                    tree_map(pick, sub) for name, sub in edge_params.items()}

        def start(a, b):
            idx = edge_idx_dev[a:b]
            params = {name: rows(local[name], a, b)
                      if local is not None and name in local else
                      tree_map(lambda leaf: leaf[idx], sub)
                      for name, sub in edge_params.items()}
            if opt_states is not None:
                return params, rows(opt_states, a, b)
            zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)
            return params, AdamState(          # every client from zeros
                step=torch.zeros((b - a,), dtype=torch.int32, device=device),
                mu=tree_map(zeros, params), nu=tree_map(zeros, params))

        def put(name, tree, a, b):
            """The chunk's rows into the round's (C, ...) stack: one
            preallocated stack written in place, so the round never holds
            a second copy of C models."""
            if len(bounds) == 1:
                out[name] = tree
                return
            if name not in out:
                out[name] = tree_map(
                    lambda x: x.new_empty((C,) + tuple(x.shape[1:])), tree)
            tree_map(lambda dst, src: dst[a:b].copy_(src), out[name], tree)

        for a, b in bounds:
            cctx = {name: rows(v, a, b) if axes.get(name) == 0 else v
                    for name, v in ctx.items() if name != "local_params"}
            p, o, losses = train_one.steps(
                lambda: start(a, b), rows(batches, a, b), valid[a:b],
                tuple(d[a:b] for d in draws), cctx or None)
            step_losses.append(losses)
            x = start_rows(a, b) if quantized or wl is not None \
                or method == "scaffold" else None
            if wl is not None:
                # the late clients' deltas, fp32, leaf by leaf
                part = tree_map(lambda y, x_: combine_leaf(
                    y.float() - x_.float(), wl[:, a:b]), p, x)
                late = part if late is None else tree_map(torch.add, late,
                                                          part)
                del part
            if quantized:
                recon, new_err = ef_roundtrip_stacked(
                    p, rows(err, a, b), quant, start=x)
                put("recon", recon, a, b)
                put("err", new_err, a, b)
                del recon, new_err
            if method == "scaffold":
                c_new = scaffold_update(cctx["c_local"], cctx["c_global"],
                                        x, p, cctx["scale"])
                uni = torch.full((b - a,), 1.0 / C, dtype=torch.float32,
                                 device=device)
                part = tree_map(lambda n, o_: combine_leaf(n - o_, uni),
                                c_new, cctx["c_local"])
                dc = part if dc is None else tree_map(torch.add, dc, part)
                put("c_new", c_new, a, b)
                del c_new
            if not quantized or method in KEEPS_TRAINED:
                put("trained", p, a, b)
            if opt_states is not None:
                put("opt", o, a, b)
            del p, o, x
        # the edge decodes start + deq when the uplink is quantized
        sent = out.pop("recon") if quantized else out["trained"]
        out.update(agg=weighted_average_stacked(sent, w_mat),
                   losses=device_means(torch.cat(step_losses),
                                       host_to_device(valid, device)))
        del sent
        if method not in KEEPS_TRAINED:
            out.pop("trained", None)
        if wl is not None:
            out["late"] = late
        if method == "scaffold":
            out["dc_mean"] = dc
        return out

    return engine


def uniform_batch_shape(clients) -> Optional[tuple]:
    """The clients' common (B, H, W, ch) batch shape, or None if they
    differ (a client with fewer images than the batch size): the
    vectorized engine needs one."""
    shapes = {(c.data.batch_size,) + tuple(c.data.images.shape[1:])
              for c in clients}
    return shapes.pop() if len(shapes) == 1 else None


def route_engine(engine: str, strict: bool, round_clients, warned: bool,
                 trainer: str = "FedPhD",
                 method: str = "") -> Tuple[bool, bool]:
    """``(use_vectorized, warned)`` for one round.  Clients of ragged
    batch shapes fall back to the sequential engine, with a warning once
    per trainer (``warned`` carries that across its rounds); an
    explicitly requested (strict) ``"vectorized"`` raises instead.  The
    warning names ``trainer`` and ``method``: Python shows a message once
    per place, so two trainers' fallbacks must differ in their text."""
    if engine == "sequential":
        return False, warned
    uniform = uniform_batch_shape(round_clients) is not None
    if not uniform:
        if engine == "vectorized" and strict:
            raise ValueError("vectorized engine needs a uniform client "
                             "batch shape; use engine='auto' or "
                             "'sequential' for ragged clients")
        if not warned:
            warnings.warn(f"ragged client batch shapes: {trainer} "
                          f"(method={method or trainer}, engine={engine}) "
                          "falling back to the sequential round engine",
                          RuntimeWarning)
            warned = True
    return uniform, warned
