"""The MoE and MLA layers of the port and the three configs that need
only them, against the JAX package.

``moonshot-v1-16b-a3b`` (a dense head layer, then MoE with shared
experts), ``qwen3-moe-235b-a22b`` (GQA, MoE in every layer) and
``deepseek-v3-671b`` (MLA, a dense head layer, MoE with a shared
expert), each as the reference's smoke variant, with non-degenerate
weights drawn from a numpy seed and carried across by
``repro_torch.convert``: the configs, the router, capacity and dispatch
(a case that drops pairs among them), ``apply_moe`` and its gradients,
``apply_mla`` and the absorbed ``mla_decode``; for each model the
hidden states, aux loss, loss and every gradient leaf, and three decode
steps; the port's prefill against its own decode with no pair dropped;
``serve_requests`` with a refill on deepseek's latent cache; the LM
CLIs; and the analytic parameter and FLOP counts.

Every reference value comes from one program (:func:`ref`), jitted once
at XLA's O0: eagerly, JAX compiles each primitive on its own.  The
port's CPU tensors run the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import TRAIN_4K as J_TRAIN_4K
from repro.configs.base import config_to_dict as jax_cfg_dict
from repro.metrics import flops as jax_flops
from repro.models import mla as jax_mla
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tfm
from repro.models.common import ApplyOptions
from repro_torch.configs import (TRAIN_4K, get_config, list_archs,
                                 smoke_variant)
from repro_torch.configs.base import DECODE_32K, PREFILL_32K, config_to_dict
from repro_torch.convert import params_from_jax, state_dict
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.metrics import flops
from repro_torch.models import mla, model, moe
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b", "deepseek-v3-671b")
B, S = 2, 64
T_DECODE, CACHE_LEN = 3, 16
# fp32 on both sides, differing only in summation order: the reference's
# tolerance for the LM logits (tests/test_torch_lm.py)
LOGIT_TOL = 1e-4
# apply_moe alone: T = 64 tokens, 4 experts top-2; a capacity factor of
# 0.3 gives 16 slots an expert against 32 pairs on average, so pairs drop
MOE_T, MOE_DROP_FACTOR = 64, 0.3
# the reference's loss without remat: remat changes only what its
# backward recomputes, not the values
NO_REMAT = ApplyOptions(remat=False)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several worker
    processes at once, and these shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r, name=""):
    """Weights (the router too) at 1/sqrt(fan_in), norm scales at
    0.1 N(0, 1), a unit-scale embedding; stacked leaves keep their first
    axis."""
    if isinstance(tree, dict):
        return {k: _randomize(v, r, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, r, name) for v in tree]
    shape = tree.shape
    if name == "embed":
        z = r.standard_normal(shape)
    elif name.startswith(("w", "lm_head", "router")):
        z = r.standard_normal(shape) / np.sqrt(shape[-2])
    else:
        z = 0.1 * r.standard_normal(shape)
    return z.astype(np.float32)


def _np_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                            jax.random.PRNGKey(0))
    return _randomize(jax.tree.map(lambda s: s, shapes),
                      np.random.default_rng(seed))


def _batch(cfg, seed=1):
    """Token ids from a numpy seed; the labels are the tokens shifted by
    one, the last position -1."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    return {"tokens": toks, "labels": labels}


def _moe_inputs():
    """deepseek's smoke MoE (a shared expert), its params, x (1, T, d)
    and a cotangent."""
    jcfg = jax_smoke_variant("deepseek-v3-671b")
    r = np.random.default_rng(3)
    shapes = jax.eval_shape(lambda k: jax_moe.init_moe(
        k, jcfg.d_model, jcfg.moe, activation=jcfg.activation),
        jax.random.PRNGKey(0))
    p = _randomize(jax.tree.map(lambda s: s, shapes), r)
    x = r.standard_normal((1, MOE_T, jcfg.d_model)).astype(np.float32)
    ct = r.standard_normal(x.shape).astype(np.float32)
    return p, x, ct


def _mla_inputs():
    """deepseek's smoke MLA, its params, x (B, S, d), and a decode
    token against a cache filled with random rows up to each pos."""
    jcfg = jax_smoke_variant("deepseek-v3-671b")
    r = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda k: jax_mla.init_mla(
        k, jcfg.d_model, jcfg.num_heads, jcfg.mla), jax.random.PRNGKey(0))
    p = _randomize(jax.tree.map(lambda s: s, shapes), r)
    x = r.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    xd = r.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    c = r.standard_normal((B, CACHE_LEN, jcfg.mla.kv_lora_rank))
    kr = r.standard_normal((B, CACHE_LEN, jcfg.mla.qk_rope_head_dim))
    pos = np.asarray([5, 11], np.int32)
    return p, x, xd, c.astype(np.float32), kr.astype(np.float32), pos


def _router_inputs():
    r = np.random.default_rng(5)
    logits = r.standard_normal((MOE_T, 4)).astype(np.float32)
    ids = r.integers(0, 4, (MOE_T, 2)).astype(np.int32)
    return logits, ids


def _reference(models, moe_in, mla_in, router_in):
    """Every reference value the tests check, as one program."""
    out = {}
    for arch, (params, batch) in models.items():
        jcfg = jax_smoke_variant(arch)

        def loss(p):
            # model.loss_fn's sum, keeping the forward's outputs
            hidden, aux = jax_tfm.forward(p, jcfg, batch, NO_REMAT)
            return jax_tfm.chunked_xent(p, jcfg, hidden, batch["labels"],
                                        opts=NO_REMAT) + aux, (hidden, aux)
        (out[arch + "/loss"], out[arch + "/forward"]), \
            out[arch + "/grads"] = jax.value_and_grad(loss, has_aux=True)(
                params)

        def step(cache, tok):
            lg, cache = jax_model.decode(params, cache, jcfg, tok[:, None])
            return cache, lg
        cache, logits = jax.lax.scan(
            step, jax_model.init_cache(params, jcfg, B, CACHE_LEN),
            batch["tokens"][:, :T_DECODE].T)
        out[arch + "/decode"] = (logits, cache)

    jcfg = jax_smoke_variant("deepseek-v3-671b")
    p, x, ct = moe_in
    for name, factor in (("keep", jcfg.moe.capacity_factor),
                         ("drop", MOE_DROP_FACTOR)):
        m = dataclasses.replace(jcfg.moe, capacity_factor=factor)

        def f(pp, xx):
            o, aux = jax_moe.apply_moe(pp, xx, m, activation=jcfg.activation)
            return jnp.sum(o * ct) + aux, (o, aux)
        out["moe/" + name] = jax.grad(f, argnums=(0, 1), has_aux=True)(p, x)

    p, x, xd, c, kr, pos = mla_in
    positions = jnp.arange(S, dtype=jnp.int32)
    kw = dict(rope_theta=jcfg.rope_theta)
    out["mla/full"] = jax_mla.apply_mla(p, x, jcfg.mla, jcfg.num_heads,
                                        positions, chunk=16, **kw)
    out["mla/decode"] = jax_mla.mla_decode(p, xd, c, kr, jnp.asarray(pos),
                                           jcfg.mla, jcfg.num_heads, **kw)

    logits, ids = router_in
    out["router"] = jax_moe.router_topk(logits, 2)
    out["dispatch"] = jax_moe.dispatch_indices(ids, 4, 16)
    return out


@pytest.fixture(scope="module")
def inputs():
    models = {}
    for arch in ARCHS:
        models[arch] = (_np_params(jax_smoke_variant(arch)),
                        _batch(smoke_variant(arch)))
    return models, _moe_inputs(), _mla_inputs(), _router_inputs()


@pytest.fixture(scope="module")
def ref(inputs):
    """:func:`_reference`, jitted once at O0 with LLVM's expensive passes
    off."""
    program = jax.jit(_reference, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        # XLA's loop emitters: less compile CPU, the same graph
        "xla_cpu_use_fusion_emitters": False})
    return jax.tree.map(np.asarray, program(*inputs))


def _close_rel(got, want, tol=LOGIT_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def _torch(tree):
    return params_from_jax(tree, device=CPU)


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_smoke_variants_match_jax(arch):
    assert config_to_dict(get_config(arch)) == jax_cfg_dict(
        jax_get_config(arch))
    assert config_to_dict(smoke_variant(arch)) == jax_cfg_dict(
        jax_smoke_variant(arch))
    assert arch in list_archs()
    plan = tfm.stack_plan(smoke_variant(arch))
    jplan = jax_tfm.stack_plan(jax_smoke_variant(arch))
    assert (plan.n_head, plan.n_cycles, plan.pattern, plan.tail_kinds) == (
        jplan.n_head, jplan.n_cycles, jplan.pattern, jplan.tail_kinds)


@pytest.mark.parametrize("arch", ARCHS + ("recurrentgemma-9b",))
def test_flops_match_jax(arch):
    """The analytic counts of the full config and its depth-4 cut (the
    card's cells), and the port's init tree against the count."""
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_config(arch).replace(num_layers=4),
                       jax_get_config(arch).replace(num_layers=4)),
                      (smoke_variant(arch), jax_smoke_variant(arch))):
        assert flops.count_params_analytic(cfg) == \
            jax_flops.count_params_analytic(jcfg)
        assert flops.active_params(cfg) == jax_flops.active_params(jcfg)
        for shape in (TRAIN_4K, PREFILL_32K, DECODE_32K):
            jshape = dataclasses.replace(J_TRAIN_4K,
                                         **dataclasses.asdict(shape))
            assert flops.model_flops(cfg, shape) == \
                jax_flops.model_flops(jcfg, jshape)
    cfg = get_config(arch).replace(num_layers=4)
    params = model.init(cfg, torch.Generator(), device="meta")
    assert sum(v.numel() for v in tree_leaves(params)) == \
        flops.count_params_analytic(cfg)
    if arch == "moonshot-v1-16b-a3b":
        assert flops.count_params_analytic(get_config(arch)) == \
            28_386_592_768
        assert flops.active_params(get_config(arch)) == 4_804_642_816


def test_param_and_cache_trees_match_jax_at_full_size():
    """moonshot's and deepseek's full trees (keys, shapes, dtypes) and
    decode caches, abstractly on both sides (the port draws on
    ``meta``)."""
    for arch in ("moonshot-v1-16b-a3b", "deepseek-v3-671b"):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        want = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                              jax.random.PRNGKey(0))
        params = model.init(cfg, torch.Generator(), device="meta")
        shapes = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                  for k, v in state_dict(params).items()}
        assert shapes == {k: (tuple(v.shape), str(v.dtype))
                          for k, v in state_dict(want).items()}
        cache = model.init_cache(params, cfg, 8, 4096)
        jcache = jax.eval_shape(
            lambda: jax_model.init_cache(want, jcfg, 8, 4096))
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in state_dict(cache).items()} == {
            k: (tuple(v.shape), str(v.dtype))
            for k, v in state_dict(jcache).items()}


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def test_router_capacity_and_dispatch_match_jax(inputs, ref):
    logits, ids = inputs[3]
    w, i, p = moe.router_topk(torch.from_numpy(logits), 2)
    jw, ji, jp = ref["router"]
    np.testing.assert_array_equal(i.numpy(), ji)
    _close_rel(w, jw, 1e-6)
    _close_rel(p, jp, 1e-6)
    for T, k, E, f in ((8, 6, 64, 1.25), (8192, 6, 64, 1.25),
                       (4096, 8, 128, 1.25), (64, 2, 4, 0.3), (1, 1, 1, 1.0)):
        assert moe.capacity(T, k, E, f) == jax_moe.capacity(T, k, E, f)
    pos, keep = moe.dispatch_indices(torch.from_numpy(ids).long(), 4, 16)
    np.testing.assert_array_equal(pos.numpy(), ref["dispatch"][0])
    np.testing.assert_array_equal(keep.numpy(), ref["dispatch"][1])
    assert not keep.all()                       # 16 slots for ~32 pairs


@pytest.mark.parametrize("case", ["keep", "drop"])
def test_apply_moe_and_grads_match_jax(case, inputs, ref):
    """Output, aux and the gradients of sum(out * ct) + aux in every
    leaf and in x, with no pair dropped and with a third of them
    dropped (the port's spare row against the reference's zeroed adds
    into slot cap - 1)."""
    jcfg = smoke_variant("deepseek-v3-671b")
    factor = jcfg.moe.capacity_factor if case == "keep" else MOE_DROP_FACTOR
    m = dataclasses.replace(jcfg.moe, capacity_factor=factor)
    p, x, ct = inputs[1]
    tp, tx = _torch(p), torch.from_numpy(x).requires_grad_()
    for v in tree_leaves(tp):
        v.requires_grad_()
    moe.apply_moe.dropped = 0
    out, aux = moe.apply_moe(tp, tx, m, activation=jcfg.activation)
    dropped = int(moe.apply_moe.dropped)
    (gp, gx), (jout, jaux) = ref["moe/" + case]
    assert (dropped == 0) == (case == "keep")
    if case == "drop":
        assert dropped > MOE_T * 2 // 4
    _close_rel(out, jout)
    _close_rel(aux, jaux, 1e-6)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum() + aux,
                                tree_leaves(tp) + [tx])
    for g, w in zip(grads, tree_leaves(gp) + [gx]):
        _close_rel(g, w)


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

def test_apply_mla_and_absorbed_decode_match_jax(inputs, ref):
    jcfg = smoke_variant("deepseek-v3-671b")
    p, x, xd, c, kr, pos = inputs[2]
    tp = _torch(p)
    got = mla.apply_mla(tp, torch.from_numpy(x), jcfg.mla, jcfg.num_heads,
                        torch.arange(S, dtype=torch.int32), chunk=16,
                        rope_theta=jcfg.rope_theta)
    _close_rel(got, ref["mla/full"])
    tc, tkr = torch.from_numpy(c.copy()), torch.from_numpy(kr.copy())
    out, c2, kr2 = mla.mla_decode(tp, torch.from_numpy(xd), tc, tkr,
                                  torch.from_numpy(pos), jcfg.mla,
                                  jcfg.num_heads, rope_theta=jcfg.rope_theta)
    jout, jc, jkr = ref["mla/decode"]
    _close_rel(out, jout)
    assert c2 is tc and kr2 is tkr               # written in place
    _close_rel(c2, jc)
    _close_rel(kr2, jkr)
    # only the rows at pos changed
    rows = np.zeros((B, CACHE_LEN), bool)
    rows[np.arange(B), pos] = True
    np.testing.assert_array_equal(c2.numpy()[~rows], c[~rows])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, inputs, ref):
    np_params, batch = inputs[0][arch]
    cfg = smoke_variant(arch)
    tp = _torch(np_params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    hidden, aux = tfm.forward(tp, cfg, tb)
    jhidden, jaux = ref[arch + "/forward"]
    _close_rel(hidden, jhidden)
    _close_rel(aux, jaux, 1e-6)
    assert float(aux) > 0
    leaves = tree_leaves(tp)
    for v in leaves:
        v.requires_grad_()
    loss = model.loss_fn(tp, cfg, tb)
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = ref[arch + "/loss"], ref[arch + "/grads"]
    _close_rel(loss, jloss, 1e-6)
    names = list(state_dict(tp))
    jflat = state_dict(tree_map(lambda a: torch.from_numpy(np.array(a)),
                                jgrads))
    jleaves = [jflat[n] for n in names]
    assert len(grads) == len(jleaves) == len(names)
    for name, g, w in zip(names, grads, jleaves):
        assert g.shape == w.shape, name
        _close_rel(g, w.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, inputs, ref):
    np_params, batch = inputs[0][arch]
    cfg = smoke_variant(arch)
    tp = _torch(np_params)
    first = cache = model.init_cache(tp, cfg, B, CACHE_LEN)
    jlogits, jcache = ref[arch + "/decode"]
    for t in range(T_DECODE):
        lg, cache = model.decode(tp, cache, cfg, torch.from_numpy(
            batch["tokens"][:, t:t + 1]))
        _close_rel(lg, jlogits[t])
    got = state_dict(cache)
    for k, want in state_dict(tree_map(
            lambda a: torch.from_numpy(np.array(a)), jcache)).items():
        if want.dtype == torch.int32:
            assert torch.equal(got[k], want), k
        else:
            _close_rel(got[k], want.numpy())
    # decode left the cache it was given as it was
    fresh = model.init_cache(tp, cfg, B, CACHE_LEN)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(first),
                                                 tree_leaves(fresh)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_decode_without_drops(arch, inputs):
    """Eight tokens cannot drop a pair (capacity is at least 8), so the
    prefill's last logits equal the decode's after the same tokens."""
    np_params, batch = inputs[0][arch]
    cfg = smoke_variant(arch)
    tp = _torch(np_params)
    toks = torch.from_numpy(batch["tokens"][:, :8])
    moe.apply_moe.dropped = 0
    pre = model.prefill(tp, cfg, {"tokens": toks})
    assert int(moe.apply_moe.dropped) == 0
    cache = model.init_cache(tp, cfg, B, CACHE_LEN)
    for t in range(8):
        lg = model.decode_(tp, cache, cfg, toks[:, t:t + 1])
    assert int(moe.apply_moe.dropped) == 0
    assert cache["pos"].tolist() == [8, 8]
    _close_rel(lg[:, 0], pre.numpy())


def test_serve_refill_on_the_latent_cache(inputs):
    """deepseek's MLA cache through ``serve_requests``: two slots
    refilled for four requests give each request what it gets alone in
    its own slot, and a reset slot's latent rows are zero again."""
    arch = "deepseek-v3-671b"
    cfg = smoke_variant(arch)
    tp = _torch(inputs[0][arch][0])
    kw = dict(requests=4, max_tokens=4, cache_len=CACHE_LEN, seed=0)
    refilled = lm_serve.serve_requests(tp, cfg, slots=2, **kw)
    alone = lm_serve.serve_requests(tp, cfg, slots=4, **kw)
    assert refilled["outputs"] == alone["outputs"]
    assert refilled["generated"] == alone["generated"] == 16
    cache = model.init_cache(tp, cfg, 2, CACHE_LEN)
    fresh = model.init_cache(tp, cfg, 1, CACHE_LEN)
    for t in range(2):
        model.decode_(tp, cache, cfg, torch.full((2, 1), t + 1,
                                                 dtype=torch.int32))
    assert float(cache["head"][0]["c"][0, :2].abs().sum()) > 0
    model.reset_cache_slots_(cache, fresh, torch.tensor([True, False]))
    assert cache["pos"].tolist() == [0, 2]
    for leaf in ("c", "kr"):
        assert not cache["head"][0][leaf][0].any()
        assert not cache["cycles"][0][leaf][:, 0].any()
        assert cache["cycles"][0][leaf][:, 1, :2].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_clis_run_each_arch_on_cpu(arch, capsys):
    out = lm_serve.main(["--arch", arch, "--device", "cpu", "--requests",
                         "3", "--batch", "2", "--max-tokens", "2",
                         "--cache-len", "8"])
    assert sorted(out["outputs"]) == [0, 1, 2]
    res = lm_train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert f"arch={arch}-smoke" in capsys.readouterr().out
