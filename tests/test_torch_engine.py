"""The vectorized round engine of the port (``repro_torch.fl.engine``).

Its substrate against the reference's (stacked trees, gather/scatter,
the store and engine knobs, the whole-round batch stacks), the
client-axis forms of the two kernels it launches (the batched matmul and
the group-L2 member table, in their plain versions and, for group-L2,
emulated in numpy from the device descriptor), the stacked U-Net, loss
and Adam against a loop over clients, padded steps as bitwise no-ops,
one vectorized round against the reference's ``make_round_engine``, and
the port's FedPhD on its two engines.

Where a loss draws t and eps the reference cannot share the port's
draws, so both packages read them from the batch (a test-only
``monkeypatch`` of ``model.loss_fn``, as ``tests/test_torch_train.py``
does).  Between the port's own engines nothing is injected: the
vectorized engine draws the sequential engine's numbers by construction.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.configs.base import FLConfig as JFLConfig
from repro.core.pruning import build_groups as jbuild_groups
from repro.data import pipeline as jpipeline
from repro.diffusion import ddpm as jddpm
from repro.diffusion.schedule import linear_schedule as jlinear_schedule
from repro.fl import engine as jengine
from repro.models import model as jmodel
from repro.models.unet import apply_unet as japply_unet
from repro.models.unet import init_unet as jinit_unet
from repro_torch import data as tdata
from repro_torch.configs import SMOKE_UNET, FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.hfl import FedPhD
from repro_torch.core.pruning import (depth_lambdas, l2_scores, make_masks,
                                      unet_groups)
from repro_torch.core.pruning.criteria import member_table
from repro_torch.diffusion import ddpm
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.experiment.resolve import resolve_engine
from repro_torch.fl import client as tclient
from repro_torch.fl import engine
from repro_torch.kernels.block_masked_matmul import ops as bmm
from repro_torch.kernels.group_l2_norms import ops as gl2
from repro_torch.models import model as tmodel
from repro_torch.models.unet import apply_unet
from repro_torch.optim import AdamState, adam_init, adam_update
from repro_torch.tree import tree_leaves, tree_map

JCFG = JAX_SMOKE.replace(backend="xla", precision="fp32")
CFG = SMOKE_UNET.replace(precision="fp32")
ONE_LEVEL = dict(channel_mults=(1,), attn_resolutions=(16,))
T = SMOKE_UNET.diffusion_steps
CPU = torch.device("cpu")
LR = 2e-4
# the trainers' criteria of tests/test_torch_train.py: round losses within
# LOSS_RTOL; params within PARAMS_ATOL (two steps of lr: Adam moves a
# parameter whose exact gradient is zero by up to lr a step, whichever
# way rounding noise points) and, for PARAMS_BULK[1] of the values,
# within PARAMS_BULK[0]
LOSS_RTOL = 1e-5
PARAMS_ATOL = 2 * 2 * LR
PARAMS_BULK = (1e-5, 0.995)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r):
    """Weights at 1/sqrt(fan_in), norm scales near 1, small biases: the
    reference init's 1e-6 conv2/proj/conv_out would make parity trivial."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = _randomize(v, r)
                continue
            z = r.standard_normal(v.shape).astype(np.float32)
            if k == "w":
                z = z / np.sqrt(np.prod(v.shape[:-1]))
            elif k == "scale":
                z = 1.0 + 0.1 * z
            else:
                z = 0.1 * z
            out[k] = z.astype(np.float32)
        return out
    return [_randomize(v, r) for v in tree]


def _np_params(jcfg, seed):
    shapes = jax.eval_shape(lambda k: jinit_unet(k, jcfg),
                            jax.random.PRNGKey(0))
    return _randomize(shapes, np.random.default_rng(seed))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _assert_params_close(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    d = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in g])
    assert d.max() <= PARAMS_ATOL, d.max()
    assert np.mean(d <= PARAMS_BULK[0]) >= PARAMS_BULK[1]


def _stacked(trees):
    return engine.stack_trees([params_from_jax(t, CPU) for t in trees])


# ---------------------------------------------------------------------------
# (a) stacked trees, gather/scatter, the store and engine knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", ["device", "host"])
def test_stack_gather_scatter_properties(store):
    """stack/unstack round-trip; gather then scatter back is a no-op,
    permuting the selection changes nothing, and rows outside it are
    untouched (``tests/test_properties.py``'s gather/scatter property,
    on numpy and torch leaves)."""
    r = np.random.default_rng(0)
    trees = [{"a": r.standard_normal((2, 3)).astype(np.float32),
              "b": [np.full((4,), i, np.float32)]} for i in range(5)]
    if store == "device":
        trees = [tree_map(torch.from_numpy, t) for t in trees]
    back = engine.unstack_tree(engine.stack_trees(trees), 5)
    for t, b in zip(trees, back):
        for x, y in zip(tree_leaves(t), tree_leaves(b)):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    n, idx = 7, np.asarray([5, 1, 3])
    stack = engine.stacked_adam_init({"w": torch.zeros((3,))}, n,
                                     host=store == "host")
    fill = (lambda x: np.arange(x.size, dtype=x.dtype).reshape(x.shape)) \
        if store == "host" else \
        (lambda x: torch.arange(x.numel()).to(x.dtype).reshape(x.shape))
    stack = tree_map(fill, stack)
    base = [np.array(np.asarray(x)) for x in tree_leaves(stack)]
    rows = engine.tree_gather(stack, idx)
    engine.tree_scatter(stack, idx, rows)
    assert all(np.array_equal(np.asarray(x), b)
               for x, b in zip(tree_leaves(stack), base))
    new = tree_map(lambda x: x + 1, rows)
    perm = np.asarray([2, 0, 1])
    copy = lambda s: tree_map(lambda x: x.copy() if store == "host"
                              else x.clone(), s)
    out1 = engine.tree_scatter(copy(stack), idx, new)
    out2 = engine.tree_scatter(copy(stack), idx[perm],
                               tree_map(lambda x: x[perm], new))
    others = np.setdiff1d(np.arange(n), idx)
    for x, y, b in zip(tree_leaves(out1), tree_leaves(out2), base):
        assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.array_equal(np.asarray(x)[others], b[others])
        assert np.array_equal(np.asarray(x)[idx], b[idx] + 1)
    one = engine.tree_gather(stack, 3)          # a scalar drops the axis
    assert tuple(one.mu["w"].shape) == (3,) and int(one.step) == 3
    dev = engine.adam_stack_from_tree(tuple(stack), "device", CPU)
    host = engine.store_tree(dev, "host")
    assert isinstance(dev.step, torch.Tensor)
    assert isinstance(host.mu["w"], np.ndarray)
    assert all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(tree_leaves(dev), tree_leaves(host)))


def test_resolve_store_and_engine(monkeypatch):
    for args in (("auto", 20, 4), ("auto", 300, 30), ("auto", 300, 40),
                 ("device", 10000, 1), ("host", 4, 4)):
        assert engine.resolve_store(*args) == jengine.resolve_store(*args)
    with pytest.raises(ValueError, match="store"):
        engine.resolve_store("disk", 4)
    monkeypatch.delenv("FEDPHD_ENGINE", raising=False)
    assert resolve_engine() == jengine.resolve_engine() == ("auto", False)
    assert resolve_engine("sequential") == ("sequential", True)
    monkeypatch.setenv("FEDPHD_ENGINE", "vectorized")
    assert resolve_engine() == jengine.resolve_engine() \
        == ("vectorized", False)
    assert resolve_engine("sequential") == ("sequential", True)
    with pytest.raises(ValueError, match="engine"):
        resolve_engine("parallel")
    monkeypatch.setenv("FEDPHD_ENGINE", "bogus")
    with pytest.raises(ValueError, match="FEDPHD_ENGINE"):
        resolve_engine()


# ---------------------------------------------------------------------------
# (b) whole-round batch stacks, bitwise against the reference
# ---------------------------------------------------------------------------

def test_stack_round_matches_jax_bitwise():
    """A ragged client (fewer steps) pads to the round's steps; the
    shuffle streams stay in lockstep afterwards."""
    ds = dataclasses.replace(tdata.SMOKE_DATA, samples_per_class=10)
    images, labels = tdata.make_dataset(ds, seed=1)
    sizes = (24, 16, 24)
    make = lambda pkg: [pkg.ClientData(images[i * 8:i * 8 + n],
                                       labels[i * 8:i * 8 + n],
                                       batch_size=8, seed=i)
                        for i, n in enumerate(sizes)]
    tds, jds = make(tdata), make(jpipeline)
    for _ in range(2):
        got = tdata.pipeline.stack_round(tds, 2)
        want = jpipeline.stack_round(jds, 2)
        assert got[1].tolist() == want[1].tolist()
        assert want[2] and not got[1][1, -1]
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k])
    for a, b in zip(tds, jds):
        np.testing.assert_array_equal(next(a.epoch())["labels"],
                                      next(b.epoch())["labels"])


# ---------------------------------------------------------------------------
# (c) the matmul's client axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_batched_masked_matmul_matches_per_client(masked):
    """Forward, dx and dw of C products against the 2-D version client by
    client, within 1e-6 of the largest value."""
    r = np.random.default_rng(2)
    C, M, K, N = 3, 37, 29, 11
    x = torch.from_numpy(r.standard_normal((C, M, K)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((C, K, N)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((C, M, N)).astype(np.float32))
    cm = rm = None
    if masked:
        cm = torch.from_numpy((r.random(N) > 0.4).astype(np.float32))
        rm = torch.from_numpy((r.random(K) > 0.3).astype(np.float32))

    def run(xx, ww):
        xx, ww = xx.clone().requires_grad_(), ww.clone().requires_grad_()
        y = bmm.MaskedMatmul.apply(xx, ww, cm, rm)
        y.backward(g if xx.dim() == 3 else g_c)
        return y.detach(), xx.grad, ww.grad

    got = run(x, w)
    for c in range(C):
        g_c = g[c]
        want = run(x[c], w[c])
        for a, b in zip(got, want):
            scale = float(b.abs().max())
            assert float((a[c] - b).abs().max()) <= 1e-6 * scale
    if masked:                       # pruned rows/columns get no gradient
        assert float(got[2][:, rm == 0].abs().max()) == 0.0
        assert float(got[2][:, :, cm == 0].abs().max()) == 0.0


def test_plan_never_exceeds_the_grid():
    """C x splits stays within the grid's 65535 z slices, and a client
    axis splits K no more than one client alone."""
    for M, K, N in ((8, 27, 3), (512, 4608, 256), (8192, 1152, 128),
                    (64, 1024, 512), (1000, 999, 77)):
        one = bmm.plan(M, K, N)
        for C in (1, 2, 4, 100, 5000, 65535):
            p = bmm.plan(M, K, N, C)
            assert C * p.splits <= bmm.GRID_Z
            assert p.splits <= one.splits or C == 1
            steps = -(-K // p.depth())
            assert p.splits * p.per >= steps > (p.splits - 1) * p.per
    assert bmm.plan(8192, 1152, 128, 1) == bmm.plan(8192, 1152, 128)


# ---------------------------------------------------------------------------
# (d) the group-L2 member table's client axis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_stacked():
    """Randomized SMOKE params for 3 clients, stacked, with the groups."""
    trees = [_np_params(JCFG, s) for s in (11, 12, 13)]
    stacked = _stacked(trees)
    return trees, stacked, unet_groups(CFG, params_from_jax(trees[0], CPU))


def _records(tab):
    """Member, item, group and pass-2 item records of the descriptor."""
    nm, ni, ng, ni2 = tab.counts
    d, m = tab.desc, gl2.MREC
    members = d[:m * nm].reshape(nm, m)
    items = d[m * nm:m * nm + 4 * ni].reshape(ni, 4)
    groups = d[m * nm + 4 * ni:m * nm + 4 * (ni + ng)].reshape(ng, 4)
    return members, items, groups, d[m * nm + 4 * (ni + ng):].reshape(ni2, 4)


def _emulate(tensors, tab, g):
    """The kernel's passes in numpy from the descriptor, offsets and all:
    the element reads per tensor, the sums and the backward."""
    members, items, groups, items2 = _records(tab)
    flat = [t.detach().float().reshape(-1).numpy() for t in tensors]
    reads = [np.zeros(f.size, np.int64) for f in flat]
    grads = [np.zeros(f.size, np.float32) for f in flat]
    partial = np.full(tab.partial_len, np.nan, np.float32)
    for mi, c0, slab, _ in items:
        (t, _, run, _, outer, rowstride, start, R, size, base, pbase,
         pstride, _, _, rows, ncols, lo, hi) = members[mi].tolist()
        off = (hi << 32) | (lo & 0xFFFFFFFF)
        rr = np.arange(slab * rows, min(slab * rows + rows, outer))
        if run:
            cols = np.arange(c0, min(c0 + gl2.TILE_UNITS, size))
            idx = (off + rr[:, None, None] * rowstride + start
                   + cols[None, :, None] * R + np.arange(R)[None, None, :])
        else:
            cols = np.arange(c0, min(c0 + gl2.TILE_COLS, ncols))
            idx = off + rr[:, None] * rowstride + start + cols[None, :]
        np.add.at(reads[t], idx.reshape(-1), 1)
        w = flat[t][idx]
        partial[pbase + slab * pstride + cols] = \
            (w.astype(np.float64) ** 2).sum(axis=(0, 2) if run else 0)
        unit = cols[None, :, None] if run else cols[None, :] // R
        grads[t][idx] = np.float32(2.0) * w * g[base + unit]
    out = np.full(tab.out_units, np.nan, np.float32)
    for gi, u0, _, _ in items2:
        base, size, m0, m1 = groups[gi]
        ks = np.arange(u0, min(u0 + gl2.THREADS, size))
        acc = np.zeros(len(ks))
        for rec in members[m0:m1]:
            pbase, pstride, pr, nslabs = rec[10:14]
            for sl in range(nslabs):
                for r in range(pr):
                    acc += partial[pbase + sl * pstride + ks * pr + r]
        out[base + ks] = acc
    return out, reads, grads


def test_group_l2_client_axis_table(smoke_stacked):
    """The plain client-axis sums are each client's one-client sums,
    bitwise; the device descriptor reads every owned element once per
    client, its sums agree and its backward is 2 w g, bitwise."""
    trees, stacked, groups = smoke_stacked
    C = len(trees)
    tensors, tab = member_table(stacked, groups, clients=C)
    one_t, one = member_table(params_from_jax(trees[0], CPU), groups)
    assert tab.clients == C and tab.key == one.signature + (C,)
    assert tab.signature == one.signature and tab.units == one.units
    assert member_table(stacked, groups, clients=C)[1] is tab
    got = gl2.segmented_sq_norms_plain(tensors, tab)
    for c in range(C):
        want = gl2.segmented_sq_norms_plain(
            member_table(params_from_jax(trees[c], CPU), groups)[0], one)
        assert torch.equal(got[c * one.units:(c + 1) * one.units], want)
    r = np.random.default_rng(5)
    g = r.standard_normal(tab.out_units).astype(np.float32)
    out, reads, grads = _emulate(tensors, tab, g)
    owned = [torch.zeros(t.shape[1:], dtype=torch.int64) for t in tensors]
    for m, v in zip(one.members, one.views):
        owned[m.tensor].reshape(v).narrow(1, m.offset,
                                          m.size * m.chunk).add_(1)
    for rd, ow in zip(reads, owned):
        assert np.array_equal(rd, np.tile(ow.reshape(-1).numpy(), C))
    np.testing.assert_allclose(out, got.numpy(), rtol=0,
                               atol=1e-6 * float(got.abs().max()))
    plain = gl2.segmented_sq_norms_backward_plain(tensors, tab,
                                                  torch.from_numpy(g))
    for e, p in zip(grads, plain):
        assert np.array_equal(e, p.reshape(-1).numpy())


# ---------------------------------------------------------------------------
# (e) the stacked U-Net, loss and gradients
# ---------------------------------------------------------------------------

def _draws(r, C, B):
    t = torch.from_numpy(r.integers(0, T, C * B))
    eps = torch.from_numpy(r.standard_normal((C * B, 16, 16, 3))
                           .astype(np.float32))
    return t, eps


def test_stacked_unet_loss_and_grads_match_per_client(smoke_stacked):
    """apply_unet(clients=3) against each client's own forward (5e-6 of
    the largest output), and the gradients of sum_c loss_c (DDPM plus
    Omega) against each client's loss's gradients (1e-5 of the largest
    gradient of any leaf: the stacked Omega comes from one client-axis
    table, the GEMMs from the batched plain matmul)."""
    trees, stacked, groups = smoke_stacked
    C, B = len(trees), 2
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.uniform(-1, 1, (C * B, 16, 16, 3))
                         .astype(np.float32))
    t, eps = _draws(r, C, B)
    out = apply_unet(stacked, CFG, x, t, clients=C)
    singles = [params_from_jax(tr, CPU) for tr in trees]
    for c in range(C):
        want = apply_unet(singles[c], CFG, x[c * B:(c + 1) * B],
                          t[c * B:(c + 1) * B])
        err = float((out[c * B:(c + 1) * B] - want).abs().max())
        assert err <= 5e-6 * float(want.abs().max())
    with pytest.raises(ValueError, match="clients"):
        apply_unet(stacked, CFG, x, t)
    loss_fn = tclient.make_loss_fn(CFG, FLConfig(lambda0=1e-3), sparse=True,
                                   groups=groups)
    p = tree_map(lambda v: v.clone().requires_grad_(), stacked)
    losses = loss_fn(p, {"images": x}, None, clients=C, t=t, eps=eps)
    assert losses.shape == (C,)
    grads = torch.autograd.grad(losses.sum(), tree_leaves(p))
    sched = linear_schedule(T, device=CPU)
    lam = depth_lambdas(groups, 1e-3)
    from repro_torch.core.pruning import omega
    for c in range(C):
        q = tree_map(lambda v: v.clone().requires_grad_(), singles[c])
        sl = slice(c * B, (c + 1) * B)
        loss = ddpm.ddpm_loss(lambda xx, tt: apply_unet(q, CFG, xx, tt),
                              sched, x[sl], t=t[sl], eps=eps[sl]) \
            + omega(q, groups, lam)
        want = torch.autograd.grad(loss, tree_leaves(q))
        assert abs(float(losses[c].detach()) - float(loss.detach())) \
            <= 1e-6 * float(loss.detach())
        scale = max(float(w.abs().max()) for w in want)
        for a, w in zip(grads, want):
            assert float((a[c] - w).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# (f) stacked Adam
# ---------------------------------------------------------------------------

def test_stacked_adam_matches_per_client():
    """Client 0's gradient norm ~20 (clipped to 1), client 1's ~0.1 (not
    clipped): three stacked steps against per-client ``adam_update``.
    The unclipped client's rows are the same bits; the clipped one's
    norm sums its leaves in another order, so it is held to 1e-6."""
    r = np.random.default_rng(7)
    shapes = {"a": (5, 7), "b": [(3,), (2, 2, 4)]}
    mk = lambda s, scale: torch.from_numpy(
        (scale * r.standard_normal(s)).astype(np.float32))
    singles = [tree_map(lambda s: mk(s, 1.0), shapes,
                        ) for _ in range(2)]
    stacked = engine.stack_trees(singles)
    opts = [adam_init(p) for p in singles]
    sopt = AdamState(step=torch.zeros((2,), dtype=torch.int32),
                     mu=tree_map(torch.zeros_like, stacked),
                     nu=tree_map(torch.zeros_like, stacked))
    for _ in range(3):
        gs = [tree_map(lambda s: mk(s, 4.0), shapes),
              tree_map(lambda s: mk(s, 0.02), shapes)]
        for c in range(2):
            singles[c], opts[c] = adam_update(gs[c], opts[c], singles[c],
                                              lr=1e-2, grad_clip=1.0)
        stacked, sopt = adam_update(engine.stack_trees(gs), sopt, stacked,
                                    lr=1e-2, grad_clip=1.0)
    assert sopt.step.tolist() == [3, 3] and sopt.step.dtype == torch.int32
    for got, want in ((stacked, singles), (sopt.mu, [o.mu for o in opts]),
                      (sopt.nu, [o.nu for o in opts])):
        for a, b0, b1 in zip(tree_leaves(got), tree_leaves(want[0]),
                             tree_leaves(want[1])):
            assert torch.equal(a[1], b1)
            assert float((a[0] - b0).abs().max()) \
                <= 1e-6 * float(b0.abs().max())


# ---------------------------------------------------------------------------
# (g) padded steps are bitwise no-ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_padded_steps_are_bitwise_noops(seed):
    """Client 1 has n_real steps, padded to n_real + pad; its params,
    moments, step and loss mean equal a run of its real steps alone,
    bit for bit (the counterpart of ``tests/test_properties.py``'s
    padding test, which the reference's masked scan fails)."""
    r = np.random.default_rng(seed)
    n_real, pad = int(r.integers(1, 4)), int(r.integers(1, 3))
    S = n_real + pad
    xs = torch.from_numpy(r.normal(size=(2, S, 4)).astype(np.float32))
    xs[1, n_real:] = xs[1, n_real - 1]
    valid = np.ones((2, S), bool)
    valid[1, n_real:] = False
    params = {"w": torch.from_numpy(r.normal(size=(2, 4))
                                    .astype(np.float32))}

    def loss_fn(p, batch, generator, *, clients, t, eps):
        return torch.mean((batch["x"].reshape(clients, -1)
                           - p["w"]) ** 2, dim=1)

    train_one = engine.make_train_one(loss_fn, lr=0.1)
    zeros = lambda: AdamState(step=torch.zeros((2,), dtype=torch.int32),
                              mu={"w": torch.zeros((2, 4))},
                              nu={"w": torch.zeros((2, 4))})
    draws = (torch.zeros((2, S, 1)), torch.zeros((2, S, 1)))
    p_pad, o_pad, l_pad = train_one(params, zeros(), {"x": xs[:, :, None]},
                                    valid, draws)
    p_ref, o_ref, l_ref = train_one(params, zeros(),
                                    {"x": xs[:, :n_real, None]},
                                    valid[:, :n_real], draws)
    assert torch.equal(p_pad["w"][1], p_ref["w"][1])
    assert torch.equal(o_pad.mu["w"][1], o_ref.mu["w"][1])
    assert torch.equal(o_pad.nu["w"][1], o_ref.nu["w"][1])
    assert o_pad.step.tolist() == [S, n_real] == [S, int(o_ref.step[1])]
    assert l_pad[1] == l_ref[1]
    assert not torch.equal(p_pad["w"][0], p_ref["w"][0]) or pad == 0


# ---------------------------------------------------------------------------
# (h) one vectorized round against the reference's engine
# ---------------------------------------------------------------------------

def _jax_injected_loss(params, cfg, batch, rng, opts=None, *, masks=None):
    sched = jlinear_schedule(cfg.diffusion_steps)
    x_t = jddpm.q_sample(sched, batch["images"], batch["t"], batch["eps"])
    pred = japply_unet(params, cfg, x_t, batch["t"], masks=masks)
    return jnp.mean(jnp.square(batch["eps"] - pred))


def _port_injected_loss(params, cfg, batch, generator=None, *, masks=None,
                        clients=None, t=None, eps=None):
    """The port's loss with the batch's t and eps in place of the
    engine's draws."""
    sched = linear_schedule(cfg.diffusion_steps, device=CPU)
    return ddpm.ddpm_loss(
        lambda x, tt: apply_unet(params, cfg, x, tt, masks=masks,
                                 clients=clients),
        sched, batch["images"], t=batch["t"], eps=batch["eps"],
        clients=clients)


@pytest.fixture(scope="module")
def round_vs_jax():
    """One sparse round of two clients of a one-level SMOKE U-Net, one of
    them padded (2 real steps and 1), through the reference's
    ``make_round_engine(sparse=True, groups=..., prune_masks=...)`` (its
    loss: ``model.loss_fn(masks=)`` plus Omega) and the port's, on the
    same params, batches, (E, C) rows, 0.44 prune masks and injected t
    and eps; the port's also without the masks."""
    jcfg, cfg = JCFG.replace(**ONE_LEVEL), CFG.replace(**ONE_LEVEL)
    edges = [_np_params(jcfg, s) for s in (21, 22)]
    r = np.random.default_rng(8)
    C, S, B = 2, 2, 4
    batches = {"images": r.uniform(-1, 1, (C, S, B, 16, 16, 3))
               .astype(np.float32),
               "t": r.integers(0, T, (C, S, B)).astype(np.int32),
               "eps": r.standard_normal((C, S, B, 16, 16, 3))
               .astype(np.float32)}
    batches["images"][1, 1] = batches["images"][1, 0]   # padding repeats
    valid = np.asarray([[True, True], [True, False]])
    edge_idx = np.asarray([1, 0])
    w_mat = np.asarray([[0.0, 1.0], [0.7, 0.3]], np.float32)
    tp0 = params_from_jax(edges[0], CPU)
    groups = unet_groups(cfg, tp0)
    masks = make_masks(l2_scores(tp0, groups), groups, 0.44)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "loss_fn", _jax_injected_loss)
        mp.setattr(tmodel, "loss_fn", _port_injected_loss)
        # inputs are stacked in numpy and only put on the device: an
        # eager jnp op compiles a program of its own
        put = lambda tree: jax.tree.map(jnp.asarray, tree)
        jgroups = jbuild_groups(jcfg, put(edges[0]))
        # unroll=1: one copy of the step in the program keeps the compile
        # short
        jeng = jengine.make_round_engine(
            jcfg, JFLConfig(lambda0=1e-3), sparse=True, groups=jgroups,
            lr=LR, unroll=1,
            prune_masks={k: jnp.asarray(v.numpy()) for k, v in masks.items()})
        args = (put(jax.tree.map(lambda *l: np.stack(l), *edges)),
                jnp.asarray(edge_idx.astype(np.int32)), put(batches),
                jnp.asarray(valid), jnp.asarray(np.zeros((C, 2), np.uint32)),
                jnp.asarray(w_mat))
        # the reference's own program, with LLVM's optimisation passes
        # off: the same XLA graph compiles in ~3/4 of the time
        want = jeng.lower(*args, masked=True).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True,
            # XLA's loop emitters: less compile CPU, the same graph
            "xla_cpu_use_fusion_emitters": False})(*args)
        tb = {k: torch.from_numpy(v) for k, v in batches.items()}
        got = {}
        for label, pm in (("masked", masks), ("unmasked", None)):
            teng = engine.make_round_engine(cfg, FLConfig(lambda0=1e-3),
                                            sparse=True, groups=groups,
                                            lr=LR, prune_masks=pm)
            got[label] = teng(_stacked(edges), edge_idx, tb, valid,
                              (tb["t"].long(), tb["eps"]), w_mat)
            # the engine returns the (C,) losses on the device, unsynced
            got[label]["losses"] = got[label]["losses"].numpy()
    return want, got


def test_round_engine_matches_jax(round_vs_jax):
    """The port's round against the reference's: per-client losses
    within LOSS_RTOL, the edge aggregates within the trainers' params
    criterion (the reference's padded scan is not bitwise; ROADMAP C)."""
    want, got = round_vs_jax
    np.testing.assert_allclose(got["masked"]["losses"],
                               np.asarray(want["losses"]), rtol=LOSS_RTOL)
    _assert_params_close(got["masked"]["agg"], want["agg"])


# ---------------------------------------------------------------------------
# (i) the port's FedPhD: sequential against vectorized
# ---------------------------------------------------------------------------

FL_KW = dict(num_clients=4, num_edges=2, participation=1.0, rounds=3,
             sparse_rounds=2, cloud_agg_every=2, edge_agg_every=1,
             lambda0=1e-3)


def _clients(sizes=(4, 4, 4, 2), batch=2):
    """4 clients of 2 classes each; the last holds 2 images, so it takes
    1 step a round where the others take 2 (the same batch shape)."""
    ds = dataclasses.replace(tdata.SMOKE_DATA, samples_per_class=8)
    images, labels = tdata.make_dataset(ds, seed=0)
    parts = tdata.shards_per_client(labels, 4, 2, seed=0)
    return [tclient.Client(i, tdata.ClientData(images[p][:n], labels[p][:n],
                                               batch_size=batch, seed=i),
                           ds.num_classes)
            for i, (p, n) in enumerate(zip(parts, sizes))]


def _train(engine_name, rounds=3, sizes=(4, 4, 4, 2), **kw):
    tr = FedPhD(CFG, FLConfig(**{**FL_KW, "rounds": rounds}),
                _clients(sizes), rng_seed=0, device="cpu",
                engine=engine_name, **kw)
    used = []
    gather, tr.gathered = tr._opt_rows, []
    tr._opt_rows = lambda idx: tr.gathered.append(gather(idx)) \
        or tr.gathered[-1]
    for name in ("_local_and_edge_sequential", "_local_and_edge_vectorized"):
        inner = getattr(tr, name)

        def rec(*a, _inner=inner, _name=name):
            used.append(_name)
            return _inner(*a)
        setattr(tr, name, rec)
    hist, _ = tr.run()
    return tr, hist, used


@pytest.fixture(scope="module")
def engines():
    return {e: _train(e) for e in ("sequential", "vectorized")}


def test_fedphd_engines_agree(engines):
    """Sparse -> prune at R_s -> plain, with a ragged client: identical
    selections, bitwise bytes, params_m and prune report; losses within
    LOSS_RTOL; params within the trainers' criterion."""
    (seq, hs, us), (vec, hv, uv) = engines["sequential"], \
        engines["vectorized"]
    assert us == ["_local_and_edge_sequential"] * 3
    assert uv == ["_local_and_edge_vectorized"] * 3
    assert [h.pruned for h in hv] == [False, True, False]
    for a, b in zip(hs, hv, strict=True):
        assert (a.selected, a.comm_gb, a.comm_up_gb, a.comm_down_gb,
                a.params_m, a.pruned, a.edge_sh) == \
            (b.selected, b.comm_gb, b.comm_up_gb, b.comm_down_gb,
             b.params_m, b.pruned, b.edge_sh)
        assert abs(a.loss - b.loss) <= LOSS_RTOL * abs(a.loss)
    assert vec.prune_report == seq.prune_report and vec.cfg == seq.cfg
    _assert_params_close(vec.params, seq.params)
    assert len(vec.round_seconds) == 3 and not vec.step_seconds


def test_fedphd_persistent_opt_and_host_store():
    """persistent_opt on both engines over the prune (the stacks reset
    there), and the host store bitwise equal to the device store."""
    runs = {(e, s): _train(e, rounds=2, sizes=(2, 2, 2, 2),
                           persistent_opt=True, state_store=s)
            for e, s in (("sequential", "device"), ("vectorized", "device"),
                         ("vectorized", "host"))}
    seq = runs["sequential", "device"][0]
    vec, host = runs["vectorized", "device"][0], runs["vectorized", "host"][0]
    assert isinstance(host._opt_stack.step, np.ndarray)
    assert isinstance(vec._opt_stack.step, torch.Tensor)
    # reset at the prune in round 2, and no round since
    assert vec._opt_stack.step.tolist() == [0] * 4
    hs, hv = runs["sequential", "device"][1], runs["vectorized", "device"][1]
    for a, b in zip(hs, hv, strict=True):
        assert abs(a.loss - b.loss) <= LOSS_RTOL * abs(a.loss)
    _assert_params_close(vec.params, seq.params)
    assert [h.to_dict() for h in runs["vectorized", "host"][1]] == \
        [h.to_dict() for h in hv]
    for a, b in zip(tree_leaves(host.params), tree_leaves(vec.params)):
        assert torch.equal(a, b)
    # round 2 started from round 1's moments: one step each
    assert [rows.step.tolist() for rows in vec.gathered] == \
        [[0] * 4, [1] * 4]


# ---------------------------------------------------------------------------
# (j) routing and the masked sparse-phase loss
# ---------------------------------------------------------------------------

def test_ragged_batch_shapes_route_sequential():
    """A client smaller than the batch has another batch shape: "auto"
    warns once and trains it sequentially; an explicit "vectorized"
    raises."""
    fl = FLConfig(**{**FL_KW, "rounds": 1, "sparse_rounds": 0})
    clients = _clients(sizes=(4, 4, 4, 1))
    assert engine.uniform_batch_shape(clients) is None
    tr = FedPhD(CFG, fl, clients, device="cpu", engine="auto")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert not tr._use_vectorized(clients)
        assert not tr._use_vectorized(clients)
    assert len([w for w in seen if "ragged" in str(w.message)]) == 1
    strict = FedPhD(CFG, fl, clients, device="cpu", engine="vectorized")
    with pytest.raises(ValueError, match="uniform"):
        strict.run()
    assert engine.uniform_batch_shape(_clients()) == (2, 16, 16, 3)


def test_masked_loss_matches_jax(round_vs_jax):
    """The sparse-phase loss on prune masks (``prune_masks``: masked
    GEMMs, one mask per group shared by every client) is the reference's
    ``model.loss_fn(masks=)``: the round's per-client losses agree with
    the reference's masked round within LOSS_RTOL, where the same round
    without the masks does not."""
    want, got = round_vs_jax
    ref = np.asarray(want["losses"])
    np.testing.assert_allclose(got["masked"]["losses"], ref, rtol=LOSS_RTOL)
    assert np.all(np.abs(got["unmasked"]["losses"] - ref)
                  > 100 * LOSS_RTOL * np.abs(ref))
