"""RWKV-6 in the port against the JAX package.

The WKV recurrence (``kernels/wkv6/ops.py``): its plain forward against
the reference's ``_wkv_scan`` from a nonzero state, the chunk-parallel
route against ``_wkv_chunked`` (slow decays, and decays with ``w0``
near 0, w ~ 0.07-0.4, where the +-25 clamp acts), and all six gradients
of :class:`WKV6` (its CPU backward is the plain one) against
``jax.vjp`` through ``_wkv_scan``.  The layers (``models/rwkv6.py``):
``apply_tmix`` with and without a state in both decay regimes,
``apply_cmix`` with and without one.  The stack, on
``smoke_variant("rwkv6-7b")`` (2 layers, d = 256, 4 heads of 32, fp32):
the config, smoke variant and per-shape adaptation, the hidden states of the exact and the chunked route, the loss and its
gradient per leaf, three decode steps and their states, the port's
prefill against its own decode, ``reset_cache_slots_`` on the RWKV
leaves, the full-size trees and the analytic count, ``convert`` on a
bf16 tree's fp32 ``w0`` and ``u``, and the LM CLIs.

Inputs come from a numpy seed with non-degenerate weights: the LoRA and
decay matrices at 1/sqrt(fan_in) (the reference's init draws them at
0.01, which would leave the data-dependent terms near zero), ``u`` and
the norm scales off their init.  Every reference value comes from one
program (:func:`ref`), jitted once at XLA's O0.  The port's CPU tensors
run the kernel's plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import adapt_for_shape as jax_adapt_for_shape
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs.base import config_to_dict as jax_cfg_dict
from repro.metrics import flops as jax_flops
from repro.models import model as jax_model
from repro.models import rwkv6 as jax_rwkv
from repro.models import transformer as jax_tfm
from repro.models.common import ApplyOptions
from repro_torch.configs import (INPUT_SHAPES, adapt_for_shape, get_config,
                                 get_shape, smoke_variant)
from repro_torch.configs.base import config_to_dict
from repro_torch.convert import params_from_jax, params_to_jax, state_dict
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import train as lm_train
from repro_torch.metrics import flops
from repro_torch.models import model, rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves, tree_map

ARCH = "rwkv6-7b"
CFG = smoke_variant(ARCH)
JCFG = jax_smoke_variant(ARCH)
B, S = 2, 16
T_DECODE, CACHE_LEN = 3, 8
CHUNK = 8                       # the chunked route: S = 2 chunks
# the WKV inputs: (B, S, H, K), a chunk of 16 over 32 steps (the fast
# decays' log cumulative passes -25 within 16 steps)
WB, WS, WH, WK, WCHUNK = 2, 32, 2, 16, 16
# the two decay regimes: w = exp(-exp(decay)) with decay from w0 in
# this range (the reference's init range; and near 0: w ~ 0.07-0.4)
W0 = {"slow": (-7.0, -4.0), "fast": (-0.1, 0.9)}
# fp32 on both sides, differing in summation order: x max|reference|
TOL = 1e-5
# the chunked route's products carry e^{+-25} factors under the clamp
CHUNK_TOL = 1e-4
NO_REMAT = ApplyOptions(remat=False)
CHUNKED = ApplyOptions(remat=False, wkv_chunk=CHUNK)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs in several worker
    processes at once, and these shapes gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(name, shape, r, w0):
    fan = shape[-2] if len(shape) > 1 else 1
    if name == "embed":
        return r.standard_normal(shape)
    if name.startswith("mu"):
        return r.uniform(0.0, 1.0, shape)
    if name == "w0":
        return r.uniform(*w0, shape)
    if name == "u":
        return 0.5 * r.standard_normal(shape)
    if name == "ln_scale":
        return 1.0 + 0.1 * r.standard_normal(shape)
    if name == "lora_b":
        return 0.3 * r.standard_normal(shape) / np.sqrt(fan)
    if name == "decay_b":
        return 0.5 * r.standard_normal(shape) / np.sqrt(fan)
    if name in ("lora_a", "decay_a", "lm_head") or name.startswith("w_"):
        return r.standard_normal(shape) / np.sqrt(fan)
    return 0.1 * r.standard_normal(shape)      # ln1, ln2, final_norm


def _randomize(tree, r, w0, name=""):
    if isinstance(tree, dict):
        return {k: _randomize(v, r, w0, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, r, w0, name) for v in tree]
    return _leaf(name, tree.shape, r, w0).astype(np.float32)


def _np_params(w0, seed):
    shapes = jax.eval_shape(lambda k: jax_model.init(k, JCFG),
                            jax.random.PRNGKey(0))
    return _randomize(shapes, np.random.default_rng(seed), w0)


def _wkv_inputs(w0, seed):
    """r, k, v, w (B, S, H, K), u (H, K), a nonzero state, and
    cotangents for out and the new state."""
    r = np.random.default_rng(seed)
    n = (WB, WS, WH, WK)
    rkv = [r.standard_normal(n) for _ in range(3)]
    w = np.exp(-np.exp(r.uniform(*w0, n)))
    u = 0.5 * r.standard_normal((WH, WK))
    state = r.standard_normal((WB, WH, WK, WK))
    dout = r.standard_normal(n)
    dstate = r.standard_normal((WB, WH, WK, WK))
    return tuple(a.astype(np.float32)
                 for a in (*rkv, w, u, state, dout, dstate))


def _layer(params):
    """Cycle 0's layer of a stacked tree (the smoke stack's first)."""
    return jax.tree.map(lambda a: a[0], params["cycles"][0])


def _reference(wkv_in, models, xs, batch):
    """Every reference value the tests check, as one program."""
    out = {}
    for regime, (r, k, v, w, u, st, dout, dst) in wkv_in.items():
        out[f"scan/{regime}"] = jax_rwkv._wkv_scan(r, k, v, w, u, st)
        out[f"chunked/{regime}"] = jax_rwkv._wkv_chunked(r, k, v, w, u, st,
                                                         WCHUNK)
        _, vjp = jax.vjp(lambda *a: jax_rwkv._wkv_scan(*a),
                         r, k, v, w, u, st)
        out[f"grads/{regime}"] = vjp((dst, dout))
    for regime, params in models.items():
        lp = _layer(params)
        x, shift, S0 = xs
        H, K = JCFG.num_heads, JCFG.head_dim
        out[f"tmix/{regime}"] = jax_rwkv.apply_tmix(lp["tmix"], x, H, K)
        out[f"tmix_state/{regime}"] = jax_rwkv.apply_tmix(
            lp["tmix"], x, H, K, state={"S": S0, "shift": shift})
        out[f"tmix_chunked/{regime}"] = jax_rwkv.apply_tmix(
            lp["tmix"], x, H, K, wkv_chunk=CHUNK)
    lp = _layer(models["slow"])
    out["cmix"] = jax_rwkv.apply_cmix(lp["cmix"], xs[0])
    out["cmix_state"] = jax_rwkv.apply_cmix(lp["cmix"], xs[0],
                                            state={"shift": xs[1]})

    params = models["slow"]

    def loss(p):
        hidden, aux = jax_tfm.forward(p, JCFG, batch, NO_REMAT)
        return jax_tfm.chunked_xent(p, JCFG, hidden, batch["labels"],
                                    opts=NO_REMAT) + aux, hidden
    (out["loss"], out["hidden"]), out["grads"] = jax.value_and_grad(
        loss, has_aux=True)(params)
    out["hidden_chunked"] = jax_tfm.forward(params, JCFG, batch, CHUNKED)[0]

    def step(cache, tok):
        lg, cache = jax_model.decode(params, cache, JCFG, tok[:, None])
        return cache, lg
    cache, logits = jax.lax.scan(
        step, jax_tfm.init_cache(params, JCFG, B, CACHE_LEN),
        batch["tokens"][:, :T_DECODE].T)
    out["decode"] = (logits, cache)
    return out


@pytest.fixture(scope="module")
def inputs():
    wkv_in = {regime: _wkv_inputs(w0, seed) for seed, (regime, w0)
              in enumerate(W0.items())}
    models = {regime: _np_params(w0, 10 + seed) for seed, (regime, w0)
              in enumerate(W0.items())}
    r = np.random.default_rng(5)
    d, H, K = CFG.d_model, CFG.num_heads, CFG.head_dim
    xs = (r.standard_normal((B, S, d)).astype(np.float32),
          r.standard_normal((B, d)).astype(np.float32),
          r.standard_normal((B, H, K, K)).astype(np.float32))
    toks = r.integers(0, CFG.vocab_size, (B, S), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    return wkv_in, models, xs, {"tokens": toks, "labels": labels}


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


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch(tree):
    return params_from_jax(tree, device=CPU)


def _tlayer(params):
    return tree_map(lambda t: t[0], _torch(params)["cycles"][0])


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", sorted(W0))
def test_wkv6_plain_matches_scan(regime, inputs, ref):
    r, k, v, w, u, st = (_t(a) for a in inputs[0][regime][:6])
    jstate, jout = ref[f"scan/{regime}"]
    out, new = wkv_ops.wkv6(r, k, v, w, u, st)
    _close(out, jout)
    _close(new, jstate)
    # the decode form writes the state it is given
    given = st.clone()
    out1, new1 = wkv_ops.wkv6(r, k, v, w, u, given, inplace=True)
    assert new1 is given and torch.equal(given, new)
    assert torch.equal(out1, out)


@pytest.mark.parametrize("regime", sorted(W0))
def test_wkv_chunked_matches_jax(regime, inputs, ref):
    r, k, v, w, u, st = (_t(a) for a in inputs[0][regime][:6])
    jstate, jout = ref[f"chunked/{regime}"]
    new, out = rwkv6.wkv_chunked(r, k, v, w, u, st, WCHUNK)
    _close(out, jout, CHUNK_TOL)
    _close(new, jstate, CHUNK_TOL)
    # where the decays are fast the clamp acts: a chunk's cumulative log
    # decay passes -25, and the chunked form leaves the exact one
    cum = torch.log(w).reshape(WB, WS // WCHUNK, WCHUNK, WH, WK).sum(2)
    if regime == "fast":
        assert float(cum.min()) < -25.0
    else:
        assert float(cum.min()) > -25.0
        _close(out, ref[f"scan/{regime}"][1], CHUNK_TOL)


@pytest.mark.parametrize("regime", sorted(W0))
def test_wkv6_gradients_match_jax(regime, inputs, ref):
    """All six gradients of :class:`WKV6` (r, k, v, w, u and the initial
    state) for cotangents on the output and the new state."""
    leaves = [_t(a).requires_grad_() for a in inputs[0][regime][:6]]
    dout, dstate = (_t(a) for a in inputs[0][regime][6:])
    out, new = wkv_ops.WKV6.apply(*leaves)
    grads = torch.autograd.grad((out, new), leaves, (dout, dstate))
    for name, g, want in zip("r k v w u state".split(), grads,
                             ref[f"grads/{regime}"]):
        assert g.shape == want.shape, name
        _close(g, want)


def test_wkv6_refuses_what_it_cannot_run():
    r = torch.zeros((1, 2, 1, 32))
    u, st = torch.zeros((1, 32)), torch.zeros((1, 1, 32, 32))
    with pytest.raises(ValueError, match="no kernel"):
        wkv_ops.wkv6(*(t.to("meta") for t in (r, r, r, r, u, st)))
    with pytest.raises(ValueError, match="state"):
        wkv_ops.wkv6(r, r, r, r, u, st[:, :, :16])
    with pytest.raises(ValueError, match="one step"):
        wkv_ops.wkv6(r[:, :0], r[:, :0], r[:, :0], r[:, :0], u, st)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", sorted(W0))
def test_apply_tmix_matches_jax(regime, inputs, ref):
    """Without a state, with one (the exact route from S0 and a shift),
    and the chunked route; the state it returns and, in place, writes."""
    x, shift, S0 = (torch.from_numpy(a) for a in inputs[2])
    lp = _tlayer(inputs[1][regime])["tmix"]
    H, K = CFG.num_heads, CFG.head_dim
    for key, kw in (("tmix", {}),
                    ("tmix_state", dict(state={"S": S0, "shift": shift})),
                    ("tmix_chunked", dict(wkv_chunk=CHUNK))):
        out, new = rwkv6.apply_tmix(lp, x, H, K, **kw)
        jout, jnew = ref[f"{key}/{regime}"]
        _close(out, jout, CHUNK_TOL if key == "tmix_chunked" else TOL)
        _close(new["S"], jnew["S"],
               CHUNK_TOL if key == "tmix_chunked" else TOL)
        assert torch.equal(new["shift"], x[:, -1])
    state = {"S": S0.clone(), "shift": shift.clone()}
    out, back = rwkv6.apply_tmix(lp, x, H, K, state=state, inplace=True)
    assert back is state
    _close(out, ref[f"tmix_state/{regime}"][0])
    _close(state["S"], ref[f"tmix_state/{regime}"][1]["S"])
    assert torch.equal(state["shift"], x[:, -1])


def test_apply_cmix_matches_jax(inputs, ref):
    x, shift, _ = (torch.from_numpy(a) for a in inputs[2])
    lp = _tlayer(inputs[1]["slow"])["cmix"]
    out, new = rwkv6.apply_cmix(lp, x)
    _close(out, ref["cmix"][0])
    assert torch.equal(new["shift"], x[:, -1])
    out, new = rwkv6.apply_cmix(lp, x, state={"shift": shift})
    _close(out, ref["cmix_state"][0])
    state = {"shift": shift.clone()}
    out2, _ = rwkv6.apply_cmix(lp, x, state=state, inplace=True)
    assert torch.equal(out2, out) and torch.equal(state["shift"], x[:, -1])


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def test_forward_loss_and_grads_match_jax(inputs, ref):
    """The hidden states on both routes, the loss and every gradient
    leaf (the port with remat, as its loss defaults to; the reference
    without: the same values)."""
    batch = inputs[3]
    tp = _torch(inputs[1]["slow"])
    toks = {"tokens": torch.from_numpy(batch["tokens"])}
    hidden, aux = tfm.forward(tp, CFG, toks)
    _close(hidden, ref["hidden"])
    assert float(aux) == 0.0
    _close(tfm.forward(tp, CFG, toks, wkv_chunk=CHUNK)[0],
           ref["hidden_chunked"], CHUNK_TOL)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    loss = model.loss_fn(tp, CFG, {**toks, "labels": torch.from_numpy(
        batch["labels"])})
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, ref["loss"], 1e-6)
    names = list(state_dict(tp))
    jflat = state_dict(tree_map(_t, ref["grads"]))
    assert len(grads) == len(names) == len(jflat)
    for name, g in zip(names, grads):
        assert g.shape == jflat[name].shape, name
        _close(g, jflat[name].numpy(), 1e-4)


def test_decode_steps_match_jax(inputs, ref):
    """Three steps from a fresh cache: the logits and every cache leaf
    (the WKV state S, shift_t, shift_c); the cache given is left as it
    was."""
    tp = _torch(inputs[1]["slow"])
    toks = inputs[3]["tokens"]
    cache = model.init_cache(tp, CFG, B, CACHE_LEN)
    given, first = cache, tree_map(torch.clone, cache)
    jlogits, jcache = ref["decode"]
    for t in range(T_DECODE):
        lg, cache = model.decode(tp, cache, CFG,
                                 torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jlogits[t])
    got = state_dict(cache)
    want = state_dict(tree_map(_t, jcache))
    assert got.keys() == want.keys()
    assert {k.rsplit(".", 1)[-1] for k in got} == {"pos", "S", "shift_t",
                                                   "shift_c"}
    for k, w in want.items():
        if w.dtype == torch.int32:
            assert torch.equal(got[k], w), k
        else:
            _close(got[k], w.numpy())
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(given),
                                                 tree_leaves(first)))


def test_prefill_equals_decode(inputs):
    """The port's last prefill logits against its decode after the same
    tokens, one at a time (the WKV kernel's one-token form in place)."""
    tp = _torch(inputs[1]["fast"])
    toks = torch.from_numpy(inputs[3]["tokens"]).long()
    pre = model.prefill(tp, CFG, {"tokens": toks})
    cache = model.init_cache(tp, CFG, B, S)
    for t in range(S):
        lg = model.decode_(tp, cache, CFG, toks[:, t:t + 1])
    assert cache["pos"].tolist() == [S] * B
    _close(lg[:, 0], pre.numpy(), 1e-4)


def test_reset_cache_slots_on_rwkv_leaves(inputs):
    """A reset slot's S and shifts are fresh again, the other slot's
    untouched; a refilled serving run gives each request what it gets
    alone."""
    tp = _torch(inputs[1]["slow"])
    cache = model.init_cache(tp, CFG, 2, CACHE_LEN)
    for t in range(2):
        model.decode_(tp, cache, CFG, torch.full((2, 1), t + 1,
                                                 dtype=torch.int32))
    kept = tree_map(torch.clone, cache)
    fresh = model.init_cache(tp, CFG, 1, CACHE_LEN)
    model.reset_cache_slots_(cache, fresh, torch.tensor([False, True]))
    st = cache["cycles"][0]
    for key in ("S", "shift_t", "shift_c"):
        assert kept["cycles"][0][key][:, 1].any(), key
        assert not st[key][:, 1].any(), key
        assert torch.equal(st[key][:, 0], kept["cycles"][0][key][:, 0])
    assert cache["pos"].tolist() == [2, 0]
    kw = dict(requests=4, max_tokens=3, cache_len=CACHE_LEN, seed=0)
    refilled = lm_serve.serve_requests(tp, CFG, slots=2, **kw)
    alone = lm_serve.serve_requests(tp, CFG, slots=4, **kw)
    assert refilled["outputs"] == alone["outputs"]


def test_config_smoke_variant_and_shapes_match_jax():
    """rwkv6-7b, its smoke variant and its per-shape adaptation (RWKV is
    natively sub-quadratic: long_500k leaves it as it is) field for
    field, and the stack plan."""
    assert config_to_dict(get_config(ARCH)) == jax_cfg_dict(
        jax_get_config(ARCH))
    assert config_to_dict(CFG) == jax_cfg_dict(JCFG)
    for name in INPUT_SHAPES:
        got = adapt_for_shape(get_config(ARCH), get_shape(name))
        assert got == get_config(ARCH)
        assert config_to_dict(got) == jax_cfg_dict(jax_adapt_for_shape(
            jax_get_config(ARCH), jax_get_shape(name)))
    plan, jplan = tfm.stack_plan(CFG), jax_tfm.stack_plan(JCFG)
    assert (plan.n_head, plan.n_cycles, plan.pattern, plan.tail_kinds) == (
        jplan.n_head, jplan.n_cycles, jplan.pattern, jplan.tail_kinds)


def test_trees_and_counts_match_jax_at_full_size():
    """rwkv6-7b's full tree (keys, shapes, dtypes: ``w0`` and ``u``
    fp32) and decode cache, abstractly on both sides; the analytic
    count of the full config and of its smoke variant against the
    reference's and against the port's init on ``meta``."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    want = jax.eval_shape(lambda k: jax_model.init(k, jcfg),
                          jax.random.PRNGKey(0))
    params = model.init(cfg, torch.Generator(), device="meta")
    shapes = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
              for k, v in state_dict(params).items()}
    assert shapes == {k: (tuple(v.shape), str(v.dtype))
                      for k, v in state_dict(want).items()}
    cache = model.init_cache(params, cfg, 8, 4096)
    jcache = jax.eval_shape(lambda: jax_model.init_cache(want, jcfg, 8,
                                                         4096))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in state_dict(cache).items()} == {
        k: (tuple(v.shape), str(v.dtype))
        for k, v in state_dict(jcache).items()}
    n = sum(v.numel() for v in tree_leaves(params))
    assert n == flops.count_params_analytic(cfg) \
        == jax_flops.count_params_analytic(jcfg) == 7_576_621_056
    assert flops.count_params_analytic(CFG) \
        == jax_flops.count_params_analytic(JCFG)


def test_convert_keeps_fp32_leaves_of_a_bf16_tree():
    """A bf16 model's ``w0`` and ``u`` stay fp32 through the init and
    both directions of ``convert``."""
    cfg = CFG.replace(dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = model.init(cfg, gen, device="cpu")
    dtypes = {k.rsplit(".", 1)[-1]: v.dtype
              for k, v in state_dict(tp).items()}
    assert dtypes["w0"] == dtypes["u"] == torch.float32
    assert dtypes["w_r"] == dtypes["mu"] == torch.bfloat16
    back = params_from_jax(params_to_jax(tp), device=CPU)
    # params_to_jax hands bf16 leaves over as fp32: cast back by name
    for (k, a), b in zip(state_dict(tp).items(), state_dict(back).values()):
        assert torch.equal(b.to(a.dtype), a), k
        if k.endswith(("w0", "u")):
            assert b.dtype == torch.float32 and torch.equal(b, a), k


def test_lm_clis_run_rwkv_on_cpu(capsys):
    out = lm_serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "3", "--batch", "2", "--max-tokens", "2",
                         "--cache-len", "8"])
    assert sorted(out["outputs"]) == [0, 1, 2]
    res = lm_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16"])
    assert all(np.isfinite(res["losses"]))
    assert res["losses"][-1] < res["losses"][0]
    assert capsys.readouterr().out.count(f"arch={ARCH}-smoke") == 2
