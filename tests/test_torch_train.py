"""The training slice of the port against the JAX package.

On ``SMOKE_UNET`` with non-degenerate weights from a numpy seed: the
DDPM loss, Omega and its depth scales, compaction, Adam, aggregation,
one local step (fp32 and bf16, with Omega), the data pipeline, SH
selection, and a whole FedPhD run through sparse -> prune at R_s ->
plain rounds on the reference's sequential engine.

The port cannot reproduce ``jax.random``, so wherever a loss draws t and
eps both packages get the same numpy draws: the clients' batches carry
``t`` and ``eps``, and ``model.loss_fn`` is replaced, in each package and
only inside the test (``monkeypatch``), by the same epsilon loss computed
from ``batch["t"]`` and ``batch["eps"]`` with that package's own
``q_sample``, schedule and U-Net.  The trainers call it through the
module attribute, so no file of either package changes.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.configs.base import FLConfig as JFLConfig
from repro.core import aggregation as jagg
from repro.core.selection import random_selection as jrandom_selection
from repro.core.selection import select_edge as jselect_edge
from repro.core.sh_score import AccumulatedDistribution as JAccumulated
from repro.core.sh_score import sh_score as jsh_score
from repro.core import hfl as jhfl
from repro.core.hfl import FedPhD as JFedPhD
from repro.core.pruning import build_groups as jbuild_groups
from repro.core.pruning.compact import compact_config as jcompact_config
from repro.core.pruning.compact import compact_params as jcompact_params
from repro.core.pruning import depth_lambdas as jdepth_lambdas
from repro.core.pruning import keep_indices as jkeep_indices
from repro.core.pruning import l2_scores as jl2_scores
from repro.core.pruning import make_masks as jmake_masks
from repro.core.pruning import omega as jomega
from repro.diffusion import ddpm as jddpm
from repro.diffusion.schedule import linear_schedule as jlinear_schedule
from repro.fl import client as jclient
from repro.fl.compress import downlink_bytes as jdownlink_bytes
from repro.fl.compress import uplink_bytes as juplink_bytes
from repro.models import model as jmodel
from repro.models.unet import apply_unet as japply_unet
from repro.models.unet import init_unet as jinit_unet
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro_torch import data as tdata
from repro_torch.configs import SMOKE_UNET, FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import aggregation as tagg
from repro_torch.core.selection import random_selection, select_edge
from repro_torch.core.sh_score import AccumulatedDistribution, sh_score
from repro_torch.core.hfl import FedPhD
from repro_torch.core.pruning import (compact, depth_lambdas, keep_indices,
                                      l2_scores, make_masks, omega,
                                      unet_groups)
from repro_torch.diffusion import ddpm
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.fl import client as tclient
from repro_torch.fl.compress import downlink_bytes, uplink_bytes
from repro_torch.models import model as tmodel
from repro_torch.models.unet import apply_unet
from repro_torch.optim import adam_init, adam_update
from repro_torch.tree import tree_leaves

JCFG = JAX_SMOKE.replace(backend="xla", precision="fp32")
CFG = SMOKE_UNET.replace(precision="fp32")
T = SMOKE_UNET.diffusion_steps
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch from oversubscribing the cores (the
    small shapes here gain nothing from more)."""
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


@pytest.fixture(scope="module")
def np_params():
    shapes = jax.eval_shape(lambda k: jinit_unet(k, JCFG),
                            jax.random.PRNGKey(0))
    return _randomize(shapes, np.random.default_rng(0))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict/list tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


# The reference's jitted local steps compile at XLA's backend level 0
# with LLVM's expensive passes off.  A SMOKE sparse step then compiles in
# about 11 CPU-s (about 5 s on the clock: the compile is multi-threaded)
# against about 18.5 CPU-s at level 1, and runs in about 0.5 CPU-s a step
# against 0.32: the FedPhD run's three step programs and 24 steps cost
# about 46 CPU-s at level 0 against about 63 at level 1, and the test
# suite runs in several processes at once, so CPU seconds are what it
# pays.  XLA's fusion emitters are off too (its loop emitters compile
# the same graph): this module's CPU time in one process falls from
# about 170 to 141 s, the reference trainer's losses unchanged.
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True,
      "xla_cpu_use_fusion_emitters": False}


def _fast_reference_jit(mp, options=O0):
    """Every ``jax.jit`` made while ``mp`` is active compiles with
    ``options`` (the reference builds its steps with ``@jax.jit``), and
    the reference's aggregations, its clients' fresh Adam states and its
    prune (masks and compaction) run as one program per tree instead of
    eagerly (``_jitted_weighted_average``, ``_adam_init_o0``,
    ``_make_masks_o0``, ``_compact_o0``)."""
    mp.setattr(jax, "jit", functools.partial(jax.jit,
                                             compiler_options=options))
    mp.setattr(jagg, "weighted_average", _jitted_weighted_average)
    mp.setattr(jclient, "adam_init", _adam_init_o0)
    mp.setattr(jhfl, "adam_init", _adam_init_o0)
    mp.setattr(jhfl, "make_masks", _make_masks_o0)
    mp.setattr(jhfl, "compact", _compact_o0)


# the reference's zero Adam state: eagerly each leaf shape compiles its
# own zeros
_adam_init_o0 = jax.jit(jadam_init, compiler_options=O0)


def _make_masks_o0(scores, groups, ratio):
    """The reference's ``make_masks`` as one program."""
    return jax.jit(lambda s: jmake_masks(s, groups, ratio),
                   compiler_options=O0)(scores)


def _compact_o0(params, cfg, groups, masks):
    """The reference's ``compact`` (``compact_params``, then
    ``compact_config`` and the report) with the parameter gathers as one
    program; the kept counts and indices, which set its shapes, come
    from the masks as constants."""
    masks = {k: np.asarray(v) for k, v in masks.items()}
    kept = {}

    def gather(p):
        with jax.ensure_compile_time_eval():
            new, counts = jcompact_params(p, groups, masks)
        kept.update(counts)
        return new

    new = jax.jit(gather, compiler_options=O0)(params)
    return new, jcompact_config(cfg, groups, kept), {
        g.name: (kept[g.name], g.size) for g in groups}


def _l2_scores_o0(params, groups, **kw):
    """The reference's L2 prune scores as one program: eagerly it
    compiles one per op and group shape."""
    return jax.jit(lambda p: jl2_scores(p, groups, **kw),
                   compiler_options=O0)(params)


@functools.partial(jax.jit, compiler_options=O0)
def _average_trees(trees, w):
    return jax.tree.map(lambda *leaves: jagg.combine_leaf(jnp.stack(leaves),
                                                          w), *trees)


def _jitted_weighted_average(param_trees, weights):
    """The reference's ``weighted_average`` op for op (normalized fp32
    weights, each leaf stacked and contracted by ``combine_leaf``) in one
    program: run eagerly it compiles one XLA program per op and leaf
    shape, ~10 s of the FedPhD run below."""
    w = np.asarray(jagg.normalize_weights(weights), np.float32)
    return _average_trees(list(param_trees), jnp.asarray(w))


def _max_abs_diff(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        assert g[k].shape == w[k].shape, k
    return max(float(np.abs(g[k] - w[k]).max()) for k in g)


# ---------------------------------------------------------------------------
# injected draws: the same numpy t and eps reach both packages
# ---------------------------------------------------------------------------

def _jax_injected_loss(params, cfg, batch, rng, opts=None, *, masks=None):
    sched = jlinear_schedule(cfg.diffusion_steps)
    x_t = jddpm.q_sample(sched, batch["images"], batch["t"], batch["eps"])
    pred = japply_unet(params, cfg, x_t, batch["t"], masks=masks)
    return jnp.mean(jnp.square(batch["eps"] - pred))


def _port_injected_loss(params, cfg, batch, generator):
    sched = linear_schedule(cfg.diffusion_steps, device=batch["images"].device)
    return ddpm.ddpm_loss(lambda x, t: apply_unet(params, cfg, x, t), sched,
                          batch["images"], t=batch["t"], eps=batch["eps"])


def _injected(base):
    class Injected(base):
        """``ClientData`` whose batches also carry t and eps, drawn from
        a numpy stream of the client's own."""

        def __init__(self, images, labels, *, batch_size, seed):
            super().__init__(images, labels, batch_size=batch_size,
                             seed=seed)
            self._draws = np.random.default_rng(1000 + seed)

        def epoch(self):
            for b in super().epoch():
                n = len(b["images"])
                b["t"] = self._draws.integers(0, T, n).astype(np.int32)
                b["eps"] = self._draws.standard_normal(
                    b["images"].shape).astype(np.float32)
                yield b
    return Injected


def _batch(seed, B=4):
    r = np.random.default_rng(seed)
    return {"images": r.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
            "labels": np.zeros((B,), np.int32),
            "t": r.integers(0, T, B).astype(np.int32),
            "eps": r.standard_normal((B, 16, 16, 3)).astype(np.float32)}


# ---------------------------------------------------------------------------
# diffusion loss
# ---------------------------------------------------------------------------

def test_q_sample_and_ddpm_loss_with_injected_draws():
    """atol 1e-6 on values of order 1."""
    b = _batch(0)
    js, ts = jlinear_schedule(T), linear_schedule(T, device=CPU)
    want = jddpm.q_sample(js, jnp.asarray(b["images"]), jnp.asarray(b["t"]),
                          jnp.asarray(b["eps"]))
    got = ddpm.q_sample(ts, torch.from_numpy(b["images"]),
                        torch.from_numpy(b["t"]), torch.from_numpy(b["eps"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    fn = lambda x, t: 0.5 * x
    want_loss = jnp.mean(jnp.square(jnp.asarray(b["eps"]) - fn(want, None)))
    got_loss = ddpm.ddpm_loss(fn, ts, torch.from_numpy(b["images"]),
                              t=torch.from_numpy(b["t"]),
                              eps=torch.from_numpy(b["eps"]))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)


def test_ddpm_loss_draws_t_then_eps_from_its_generator():
    x0 = torch.zeros((3, 4, 4, 2))
    seen = {}

    def fn(x_t, t):
        seen["t"], seen["x_t"] = t, x_t
        return torch.zeros_like(x_t)

    sched = linear_schedule(10, device=CPU)
    loss = ddpm.ddpm_loss(fn, sched, x0, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, 10, (3,), generator=g)
    eps = torch.randn(x0.shape, generator=g)
    assert torch.equal(seen["t"], t)
    # x0 = 0, so x_t = sqrt(1 - abar_t) eps and the loss is mean(eps^2)
    assert torch.allclose(loss, torch.mean(eps ** 2))
    with pytest.raises(ValueError, match="generator"):
        ddpm.ddpm_loss(fn, sched, x0, t=t)


# ---------------------------------------------------------------------------
# Omega and compaction
# ---------------------------------------------------------------------------

def test_depth_lambdas_and_omega_match_jax(np_params):
    """Omega rtol 1e-6; its gradient atol 1e-9 (values of order 1e-4)."""
    jp = _jtree(np_params)
    tp = params_from_jax(np_params, CPU)
    jg, tg = jbuild_groups(JCFG, jp), unet_groups(CFG, tp)
    assert [g.name for g in jg] == [g.name for g in tg]
    jl, tl = jdepth_lambdas(jg, 1e-3), depth_lambdas(tg, 1e-3)
    assert jl.keys() == tl.keys()
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jomega(p, jg, jl)), compiler_options=O0)(jp)
    leaves = tree_leaves(tp)
    for v in leaves:
        v.requires_grad_()
    got = omega(tp, tg, tl)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    gw = _flat(jgrad)
    for k, v in _flat(tp).items():
        leaf = _leaf_at(tp, k)
        g = np.zeros_like(v) if leaf.grad is None else leaf.grad.numpy()
        np.testing.assert_allclose(g, gw[k], atol=1e-9, err_msg=k)


def _leaf_at(tree, path):
    for p in path.strip("/").split("/"):
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def test_compact_matches_jax(np_params):
    jp = _jtree(np_params)
    tp = params_from_jax(np_params, CPU)
    jg, tg = jbuild_groups(JCFG, jp), unet_groups(CFG, tp)
    jm = _make_masks_o0(_l2_scores_o0(jp, jg, backend="xla"), jg, 0.44)
    tm = make_masks(l2_scores(tp, tg), tg, 0.44)
    for g in tg:
        k = int(tm[g.name].sum())
        np.testing.assert_array_equal(tm[g.name].numpy(),
                                      np.asarray(jm[g.name]))
        np.testing.assert_array_equal(
            keep_indices(tm[g.name], k).numpy(),
            np.asarray(jkeep_indices(jm[g.name], k)))
    jnew, jcfg, jrep = _compact_o0(jp, JCFG, jg, jm)
    tnew, tcfg, trep = compact(tp, CFG, tg, tm)
    assert trep == jrep and tcfg == CFG and jcfg == JCFG
    # slicing copies values: exact
    assert _max_abs_diff(tnew, jnew) == 0.0
    assert sum(v.numel() for v in tree_leaves(tnew)) < \
        sum(v.numel() for v in tree_leaves(tp))


def test_compact_config_raises_for_transformers():
    """A transformer's config takes its groups' kept counts (heads with
    their q_per_kv query heads, d_ff, lru_width), ``-pruned`` appended,
    and raises where the stacked and unstacked groups of one kind keep
    different counts (the reference asserts it)."""
    from repro_torch.core.pruning import PruneGroup, compact_config
    cfg = CFG.replace(arch_type="decoder", name="lm", num_heads=8,
                      num_kv_heads=2, d_ff=64, lru_width=32)
    groups = [PruneGroup(name=n, size=s, members=(), stacked=st)
              for n, s, st in (("cyc0/heads", 2, 3), ("cyc0/ffn", 64, 3),
                               ("cyc1/lru", 32, 3), ("tail0/ffn", 64, 0))]
    kept = {"cyc0/heads": 1, "cyc0/ffn": 40, "cyc1/lru": 16,
            "tail0/ffn": 40}
    assert compact_config(cfg, groups, kept) == cfg.replace(
        name="lm-pruned", num_heads=4, num_kv_heads=1, d_ff=40,
        lru_width=16)
    assert compact_config(cfg, [], {}) == cfg
    with pytest.raises(ValueError, match="non-uniform"):
        compact_config(cfg, groups, {**kept, "tail0/ffn": 48})


# ---------------------------------------------------------------------------
# Adam and aggregation
# ---------------------------------------------------------------------------

def test_adam_three_steps_with_clip_matches_jax():
    """Gradients with norm ~20 so the clip to 1.0 acts; params rtol 1e-6
    after 3 steps (lr 1e-2), moments rtol 1e-5, the step exact."""
    r = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": [(3,), (2, 2, 4)]}
    params = {"a": r.standard_normal(shapes["a"]).astype(np.float32),
              "b": [r.standard_normal(s).astype(np.float32)
                    for s in shapes["b"]]}
    grads = [jax.tree.map(lambda p: (4.0 * r.standard_normal(p.shape)
                                     ).astype(np.float32), params)
             for _ in range(3)]
    jp, js = _jtree(params), jadam_init(_jtree(params))
    tp = params_from_jax(params, CPU)
    ts = adam_init(tp)
    # the reference's update as its trainers run it, under jit: one
    # program, where eagerly each op compiles on its own
    jupdate = jax.jit(functools.partial(jadam_update, lr=1e-2,
                                        grad_clip=1.0), compiler_options=O0)
    for g in grads:
        jp, js = jupdate(_jtree(g), js, jp)
        tp, ts = adam_update(params_from_jax(g, CPU), ts, tp, lr=1e-2,
                             grad_clip=1.0)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32
    for got, want, tol in ((tp, jp, 1e-6), (ts.mu, js.mu, 1e-5),
                           (ts.nu, js.nu, 1e-5)):
        g, w = _flat(got), _flat(want)
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=1e-7)


def test_aggregation_matches_jax():
    """fp32 weighted sums of 3 members: atol 1e-6; the integer leaf is
    rounded, not truncated, in both."""
    r = np.random.default_rng(4)
    trees = [{"w": r.standard_normal((4, 6)).astype(np.float32),
              "l": [r.standard_normal(5).astype(np.float32)],
              "step": np.asarray(3 + i, np.int32)} for i in range(3)]
    counts, mus = [10, 30, 20], [1.7, 1.9, 1.4]
    np.testing.assert_array_equal(tagg.sh_weights(counts, mus, 15000.0, 0.0),
                                  jagg.sh_weights(counts, mus, 15000.0, 0.0))
    np.testing.assert_array_equal(tagg.fedavg_weights(counts),
                                  jagg.fedavg_weights(counts))
    np.testing.assert_array_equal(tagg.normalize_weights([0, 0]),
                                  jagg.normalize_weights([0, 0]))
    tt = [params_from_jax(t, CPU) for t in trees]
    jt = [_jtree(t) for t in trees]
    for got, want in ((tagg.aggregate_sh(tt, counts, mus, 15000.0, 0.0),
                       jagg.aggregate_sh(jt, counts, mus, 15000.0, 0.0)),
                      (tagg.aggregate_fedavg(tt, counts),
                       jagg.aggregate_fedavg(jt, counts))):
        assert got["step"].dtype == torch.int32
        assert int(got["step"]) == int(want["step"])
        for k in ("w",):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-6)
        np.testing.assert_allclose(got["l"][0].numpy(),
                                   np.asarray(want["l"][0]), atol=1e-6)
    stacked = np.stack([np.asarray(t["step"]) for t in trees])
    w2 = np.asarray([[0.5, 0.25, 0.25], [0.0, 0.5, 0.5]], np.float32)
    np.testing.assert_array_equal(
        tagg.combine_leaf(torch.from_numpy(stacked),
                          torch.from_numpy(w2)).numpy(),
        np.asarray(jagg.combine_leaf(jnp.asarray(stacked),
                                     jnp.asarray(w2))))


# ---------------------------------------------------------------------------
# one local step, with Omega, fp32 and bf16
# ---------------------------------------------------------------------------

# Gradients are read off Adam's first moment, = (1 - b1) g after one
# step.  fp32: each leaf within STEP_GRAD_TOL times the largest reference
# gradient of any leaf.  A leaf's own maximum is no scale: the biases
# feeding a GroupNorm, and those of the last block before norm_out, have
# gradients that are differences of near-equal sums, or zero in exact
# arithmetic (measured 5e-10 against a largest gradient of 1.3e-2).
# Measured worst: 5.3e-7 of the largest gradient; loss 7e-8 relative.
#
# bf16 is held in the L2 norm over all leaves, against the reference's
# fp32 gradient (the port's bf16 error) and against the reference's bf16
# gradient.  Per leaf it cannot be: the reference's bf16 conv_out bias
# gradient, a reduction over every output pixel, is off its own fp32
# value by 33% of the largest gradient (measured, batch 8), where no
# leaf of the port's is off by more than 0.3%.  Measured at batch 8:
# port bf16 vs reference fp32 1.0e-2, vs reference bf16 4.5e-2 to
# 5.4e-2 over three batches; loss 1.3e-4 relative.
STEP_GRAD_TOL = 1e-5
STEP_LOSS_TOL = {"fp32": 1e-6, "bf16": 1e-3}
BF16_GRAD_L2 = {"vs_fp32": 3e-2, "vs_bf16": 1e-1}


def _rel_l2(got, want):
    g = np.concatenate([got[k].ravel() for k in want])
    w = np.concatenate([v.ravel() for v in want.values()])
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _ref_fp32_step(runs, jp, b, key):
    """The reference trainer's fp32 sparse step on these inputs, run once
    a module (both precisions of the test below read it)."""
    if "fp32_step" not in runs:
        runs["fp32_step"] = runs["ref_step_sparse"](
            jp, _adam_init_o0(jp), _jtree(b), key, {})
    return runs["fp32_step"]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_local_step_with_omega_matches_jax(np_params, runs, monkeypatch,
                                           precision):
    monkeypatch.setattr(jmodel, "loss_fn", _jax_injected_loss)
    monkeypatch.setattr(tmodel, "loss_fn", _port_injected_loss)
    jcfg, tcfg = JCFG.replace(precision=precision), \
        CFG.replace(precision=precision)
    _fast_reference_jit(monkeypatch)
    jp = _jtree(np_params)
    tp = params_from_jax(np_params, CPU)
    # the reference trainer's own fp32 sparse step: the same cfg, lambda0
    # and lr, compiled already for these shapes (batch 8)
    tstep = tclient.make_local_step(
        tcfg, FLConfig(lambda0=FL_KW["lambda0"]), sparse=True,
        groups=unet_groups(tcfg, tp), lr=2e-4)
    b = _batch(7, B=8)
    key = jax.random.PRNGKey(0)
    if precision == "fp32":
        jp2, js, jloss = _ref_fp32_step(runs, jp, b, key)
    else:
        jstep = jclient.make_local_step(
            jcfg, JFLConfig(lambda0=FL_KW["lambda0"]), sparse=True,
            groups=jbuild_groups(jcfg, jp), lr=2e-4)
        jp2, js, jloss = jstep(jp, _adam_init_o0(jp), _jtree(b), key, {})
    tp2, ts, tloss = tstep(tp, adam_init(tp), params_from_jax(b, CPU), None)
    assert abs(float(tloss) - float(jloss)) \
        <= STEP_LOSS_TOL[precision] * abs(float(jloss))
    gw, gt = _flat(js.mu), _flat(ts.mu)
    if precision == "fp32":
        scale = max(float(np.abs(v).max()) for v in gw.values())
        for k in gw:
            assert float(np.abs(gt[k] - gw[k]).max()) \
                <= STEP_GRAD_TOL * scale, k
    else:
        _, js32, _ = _ref_fp32_step(runs, jp, b, key)
        assert _rel_l2(gt, _flat(js32.mu)) <= BF16_GRAD_L2["vs_fp32"]
        assert _rel_l2(gt, gw) <= BF16_GRAD_L2["vs_bf16"]
    # params stay fp32 masters; one step moves each by at most ~lr
    assert all(v.dtype == torch.float32 for v in tree_leaves(tp2))
    assert _max_abs_diff(tp2, jp2) <= 2 * 2e-4 + 1e-6


# ---------------------------------------------------------------------------
# data, selection and byte counts: bitwise
# ---------------------------------------------------------------------------

def test_data_pipeline_matches_jax_bitwise():
    ds = dataclasses.replace(jdata.SMOKE_DATA, samples_per_class=20)
    tds = dataclasses.replace(tdata.SMOKE_DATA, samples_per_class=20)
    ji, jl = jdata.make_dataset(ds, seed=3)
    ti, tl = tdata.make_dataset(tds, seed=3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    for name, args in (("iid", (4,)), ("shards_per_client", (4, 2)),
                       ("dirichlet", (4, 0.5))):
        for a, b in zip(getattr(tdata, name)(tl, *args, seed=1),
                        getattr(jdata, name)(jl, *args, seed=1)):
            np.testing.assert_array_equal(a, b)
    jd = jdata.ClientData(ji[:30], jl[:30], batch_size=8, seed=2)
    td = tdata.ClientData(ti[:30], tl[:30], batch_size=8, seed=2)
    assert td.steps_per_epoch == jd.steps_per_epoch == 3
    for _ in range(2):
        for a, b in zip(td.epoch(), jd.epoch(), strict=True):
            np.testing.assert_array_equal(a["images"], b["images"])
            np.testing.assert_array_equal(a["labels"], b["labels"])


def test_sh_selection_matches_jax_bitwise():
    r = np.random.default_rng(5)
    jedges = [JAccumulated(4) for _ in range(3)]
    tedges = [AccumulatedDistribution(4) for _ in range(3)]
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(12):
        q = r.dirichlet(np.ones(4))
        n = int(r.integers(5, 50))
        for sel, rnd, rng, edges in ((jselect_edge, jrandom_selection, jr,
                                      jedges),
                                     (select_edge, random_selection, tr,
                                      tedges)):
            e = sel(rng, edges, q, n, a=15000.0, b=0.0)
            edges[e].update(q, n)
            rnd(rng, 3)
        assert [e.n for e in tedges] == [e.n for e in jedges]
        assert [e.sh() for e in tedges] == [e.sh() for e in jedges]
    q = np.asarray([0.7, 0.1, 0.1, 0.1])
    assert sh_score(q) == jsh_score(q)


def test_wire_bytes_match_jax(np_params):
    tp = params_from_jax(np_params, CPU)
    jp = _jtree(np_params)
    assert uplink_bytes(tp) == juplink_bytes(jp, "none")
    for prec in ("fp32", "bf16"):
        assert downlink_bytes(tp, prec) == jdownlink_bytes(jp, prec)


def test_run_local_max_steps_drains_the_shuffle_stream():
    """A capped client runs ``max_steps`` steps but shuffles every epoch,
    so its next round draws what an uncapped client's would."""
    ds = dataclasses.replace(tdata.SMOKE_DATA, samples_per_class=8)
    images, labels = tdata.make_dataset(ds, seed=0)
    make = lambda: tclient.Client(0, tdata.ClientData(
        images, labels, batch_size=8, seed=4), ds.num_classes)
    seen = []

    def step(params, opt_state, batch, generator):
        seen.append(batch["labels"].clone())
        return params, opt_state, torch.tensor(float(len(seen)))

    params = {"w": torch.zeros(2)}
    capped, full = make(), make()
    _, _, loss = tclient.run_local(step, params, capped, epochs=2,
                                   generator=None, max_steps=3)
    assert len(seen) == 3 and loss == 2.0       # mean of losses 1, 2, 3
    seen.clear()
    tclient.run_local(step, params, full, epochs=2, generator=None)
    assert len(seen) == 2 * full.data.steps_per_epoch
    a, b = next(capped.data.epoch()), next(full.data.epoch())
    np.testing.assert_array_equal(a["labels"], b["labels"])


# ---------------------------------------------------------------------------
# the trainer: sparse -> prune at R_s -> plain
# ---------------------------------------------------------------------------

# 4 clients holding 2 of 4 classes (16 images each, batch 8: 2 steps a
# round), 3 take part per round, 2 edges.  Round 1 is sparse (Omega);
# round 2 is plain on the dense model and prunes at its cloud
# aggregation; rounds 3-4 train the compacted model, round 3 from the
# edges' own models (no cloud aggregation in odd rounds).
FL_KW = dict(num_clients=4, num_edges=2, participation=0.75, rounds=4,
             sparse_rounds=2, cloud_agg_every=2, edge_agg_every=1,
             lambda0=1e-3)
# Measured on a CPU: round losses agree to 2.7e-7 relative.  Final
# params: 99.93% of the 397,667 values agree within 1e-5, the worst by
# 1.3e-4.  The worst are the biases whose exact gradient is zero (see
# STEP_TOL): Adam's normalized step m / sqrt(v) moves a parameter by up
# to lr a step whatever the gradient's size, so rounding noise of either
# sign moves them by up to lr per step, differently in each package.
LOSS_RTOL = 1e-5
PARAMS_ATOL = 2 * 2e-4            # two steps of lr
PARAMS_BULK = (1e-5, 0.995)       # this close, for at least this share


def _clients(pkg, client_mod, injected=True):
    ds = dataclasses.replace(pkg.SMOKE_DATA, samples_per_class=16)
    images, labels = pkg.make_dataset(ds, seed=0)
    parts = pkg.shards_per_client(labels, 4, 2, seed=0)
    data_cls = _injected(pkg.ClientData) if injected else pkg.ClientData
    return [client_mod.Client(i, data_cls(images[p], labels[p],
                                          batch_size=8, seed=i),
                              ds.num_classes)
            for i, p in enumerate(parts)]


def _record_assignments(trainer):
    seen = []
    inner = trainer._local_and_edge_sequential

    def rec(r, assignment, sparse_round, *args, **kw):
        seen.append((r, {e: [int(c) for c in cids]
                         for e, cids in assignment.items()}, sparse_round))
        return inner(r, assignment, sparse_round, *args, **kw)

    trainer._local_and_edge_sequential = rec
    return seen


@pytest.fixture(scope="module")
def runs(np_params):
    """The reference's and the port's FedPhD from the same params and
    draws.  The port's run goes on a second thread while the reference
    traces, compiles and runs its steps (both release the GIL in their
    native code): the two share no state, and the monkeypatches hold
    for both until both have ended."""
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        mp.setattr(jmodel, "loss_fn", _jax_injected_loss)
        mp.setattr(tmodel, "loss_fn", _port_injected_loss)
        # both trainers start from np_params; the reference takes them
        # through its init, sparing an op-by-op random init it would
        # overwrite
        mp.setattr(jmodel, "init", lambda rng, cfg: _jtree(np_params))
        _fast_reference_jit(mp)
        mp.setattr(jhfl, "l2_scores", _l2_scores_o0)
        port = FedPhD(CFG, FLConfig(**FL_KW), _clients(tdata, tclient),
                      rng_seed=0, device="cpu", engine="sequential")
        port.params = params_from_jax(np_params, CPU)
        port_seen = _record_assignments(port)
        port_run = pool.submit(port.run)
        ref = JFedPhD(JCFG, JFLConfig(**FL_KW), _clients(jdata, jclient),
                      rng_seed=0, engine="sequential")
        ref_step_sparse = ref.step_sparse
        ref_seen = _record_assignments(ref)
        ref_hist, _ = ref.run()
        port_hist, _ = port_run.result()
    return {"ref": ref, "port": port, "ref_step_sparse": ref_step_sparse,
            "ref_hist": ref_hist,
            "port_hist": port_hist, "ref_seen": ref_seen,
            "port_seen": port_seen}


def test_trainer_selections_and_assignments_identical(runs):
    assert runs["port_seen"] == runs["ref_seen"]
    assert [s for _, _, s in runs["port_seen"]] == [True, False, False,
                                                    False]
    for got, want in zip(runs["port_hist"], runs["ref_hist"], strict=True):
        assert got.round == want.round
        assert got.selected == want.selected
        assert got.edge_sh == want.edge_sh


def test_trainer_comm_and_params_m_bitwise(runs):
    for got, want in zip(runs["port_hist"], runs["ref_hist"], strict=True):
        assert got.comm_gb == want.comm_gb
        assert got.comm_up_gb == want.comm_up_gb
        assert got.comm_down_gb == want.comm_down_gb
        assert got.params_m == want.params_m
        assert got.pruned == want.pruned
    assert [h.pruned for h in runs["port_hist"]] == [False, True, False,
                                                     False]
    pm = [h.params_m for h in runs["port_hist"]]
    assert pm[1] < pm[0] and pm[1] == pm[2] == pm[3]


def test_trainer_prune_report_and_config_identical(runs):
    ref, port = runs["ref"], runs["port"]
    assert port.pruned and ref.pruned
    assert port.prune_report == ref.prune_report
    assert port.cfg == CFG and ref.cfg.name == JCFG.name
    assert [g.name for g in port.groups] == [g.name for g in ref.groups]
    assert [g.size for g in port.groups] == [g.size for g in ref.groups]


def test_trainer_losses_and_params_within_tolerance(runs):
    for got, want in zip(runs["port_hist"], runs["ref_hist"], strict=True):
        assert np.isfinite(got.loss)
        assert abs(got.loss - want.loss) <= LOSS_RTOL * abs(want.loss), \
            (got.round, got.loss, want.loss)
    assert _max_abs_diff(runs["port"].params, runs["ref"].params) \
        <= PARAMS_ATOL
    g, w = _flat(runs["port"].params), _flat(runs["ref"].params)
    d = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in g])
    assert np.mean(d <= PARAMS_BULK[0]) >= PARAMS_BULK[1]
    assert len(runs["port"].step_seconds) == 4 * 3 * 2


def test_trainer_random_selection_fedavg_matches_jax(monkeypatch):
    """The ablations' paths (random edge selection, FedAvg weights,
    no pruning): identical selections and assignments, bitwise bytes,
    losses within LOSS_RTOL."""
    monkeypatch.setattr(jmodel, "loss_fn", _jax_injected_loss)
    monkeypatch.setattr(tmodel, "loss_fn", _port_injected_loss)
    _fast_reference_jit(monkeypatch)
    # one U-Net level keeps the reference's compile short
    small = dict(channel_mults=(1,), attn_resolutions=(16,))
    jcfg, cfg = JCFG.replace(**small), CFG.replace(**small)
    params = _randomize(jax.eval_shape(lambda k: jinit_unet(k, jcfg),
                                       jax.random.PRNGKey(0)),
                        np.random.default_rng(1))
    kw = {**FL_KW, "rounds": 2}
    opts = dict(rng_seed=1, selection="random", aggregation="fedavg",
                prune=False)
    monkeypatch.setattr(jmodel, "init", lambda rng, cfg: _jtree(params))
    ref = JFedPhD(jcfg, JFLConfig(**kw), _clients(jdata, jclient),
                  engine="sequential", **opts)
    port = FedPhD(cfg, FLConfig(**kw), _clients(tdata, tclient),
                  device="cpu", engine="sequential", **opts)
    port.params = params_from_jax(params, CPU)
    seen = (_record_assignments(ref), _record_assignments(port))
    want, _ = ref.run()
    got, _ = port.run()
    assert seen[1] == seen[0]
    assert all(not s for _, _, s in seen[1])          # no sparse round
    for g, w in zip(got, want, strict=True):
        assert (g.selected, g.comm_gb, g.comm_up_gb, g.comm_down_gb,
                g.params_m, g.pruned) == (w.selected, w.comm_gb,
                                          w.comm_up_gb, w.comm_down_gb,
                                          w.params_m, w.pruned)
        assert abs(g.loss - w.loss) <= LOSS_RTOL * abs(w.loss)


@pytest.mark.parametrize("mode", ["oneshot_l2", "oneshot_random"])
def test_trainer_oneshot_prunes_at_construction(mode):
    """FedPhD-OS: the model is compacted before round 1 and no round is
    sparse."""
    fl = FLConfig(**{**FL_KW, "rounds": 1, "prune_mode": mode})
    tr = FedPhD(CFG, fl, _clients(tdata, tclient, injected=False),
                device="cpu", engine="sequential")
    assert tr.pruned and tr.step_sparse is None
    kept = sum(k for k, _ in tr.prune_report.values())
    assert kept < sum(n for _, n in tr.prune_report.values())
    hist, _ = tr.run()
    assert hist[0].params_m < 0.7 and not hist[0].pruned
    assert np.isfinite(hist[0].loss)


def test_trainer_same_seed_same_history():
    fl = FLConfig(**{**FL_KW, "rounds": 2})
    a = FedPhD(CFG, fl, _clients(tdata, tclient, injected=False),
               rng_seed=3, device="cpu", engine="sequential")
    b = FedPhD(CFG, fl, _clients(tdata, tclient, injected=False),
               rng_seed=3, device="cpu", engine="sequential")
    ha, _ = a.run()
    hb, _ = b.run()
    assert [h.to_dict() for h in ha] == [h.to_dict() for h in hb]
    assert all(np.isfinite(h.loss) for h in ha)
    assert _max_abs_diff(a.params, b.params) == 0.0


def test_trainer_needs_a_card_unless_given_cpu():
    fl = FLConfig(**FL_KW)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        FedPhD(CFG, fl, _clients(tdata, tclient), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        FedPhD(CFG, fl, _clients(tdata, tclient))
    with pytest.raises(ValueError, match="aggregation"):
        FedPhD(CFG, fl, _clients(tdata, tclient), device="cpu",
               aggregation="median")
