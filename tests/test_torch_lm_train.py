"""LM training in the port against the JAX package.

On ``smoke_variant("recurrentgemma-9b")`` (3 layers: rec, rec, local
attention; d = 256, window 64, fp32) with non-degenerate weights from a
numpy seed carried across by ``repro_torch.convert``: the chunked
cross-entropy and its gradients, the scan's backward and the RG-LRU
layer's gradients, Adam with an fp32 master and clipping (the in-place
``adam_update_`` against the functional ``adam_update``), SGD and the
schedules, three full train steps against the reference's
``build_train_step``, the bf16 step's master, ``input_specs``, and
``launch/train.py`` with its checkpoint read by the reference.

Every reference value comes from one jitted program (:func:`ref`),
compiled once at XLA's O0:
eagerly, JAX compiles each primitive on its own, 5 s for the scan
oracle's vjp and 11 s for the layer's on this suite's CPUs, and one
program saves each further jit's own trace and compile.  The
reference's train step runs there without remat: remat changes only
what its backward recomputes, and at O0 its params and losses after
three steps are bitwise those of its default.  The port's CPU tensors
run the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_checkpoint
from repro.configs import smoke_variant as jax_smoke_variant
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.configs.base import DECODE_32K as J_DECODE_32K
from repro.configs.base import PREFILL_32K as J_PREFILL_32K
from repro.configs.base import TRAIN_4K as J_TRAIN_4K
from repro.kernels.rglru_scan.ref import rglru_scan_ref
from repro.launch.steps import build_opt_init as jax_build_opt_init
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models import model as jax_model
from repro.models import rglru as jax_rglru
from repro.models import transformer as jax_tfm
from repro.models.common import ApplyOptions
from repro.optim import adam_init as jadam_init
from repro.optim import adam_update as jadam_update
from repro.optim import constant as jconstant
from repro.optim import cosine_decay as jcosine_decay
from repro.optim import sgd_init as jsgd_init
from repro.optim import sgd_update as jsgd_update
from repro_torch import checkpoint
from repro_torch.configs import (DECODE_32K, PREFILL_32K, TRAIN_4K,
                                 get_config, list_archs, smoke_variant)
from repro_torch.convert import params_from_jax, state_dict
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.launch import train as lm_train
from repro_torch.launch.steps import build_opt_init, build_train_step
from repro_torch.models import model, rglru
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamState, adam_from_tree, adam_init,
                               adam_update, adam_update_, constant,
                               cosine_decay, sgd_init, sgd_update)
from repro_torch.tree import tree_leaves, tree_map

ARCH = "recurrentgemma-9b"
JCFG = jax_smoke_variant(ARCH)
CFG = smoke_variant(ARCH)
B, S = 2, 128                 # past the smoke window of 64
STEPS, LR = 3, 1e-3
CAPS = (0.0, 30.0)
MOMENTA = (0.0, 0.9)
ADAM_KW = dict(lr=1e-2, grad_clip=1.0)
SCHED_STEPS = np.arange(26)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(tree, r, name=""):
    """Weights at 1/sqrt(fan_in), norm scales and biases at 0.1 N(0,1),
    the conv taps at 0.3 N(0,1), log_lambda in the init's [-4.3, -1),
    a unit-scale embedding (``tests/test_torch_lm.py``'s draws)."""
    if isinstance(tree, dict):
        return {k: _randomize(v, r, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize(v, r, name) for v in tree]
    shape = tree.shape
    if name == "log_lambda":
        z = r.uniform(-4.3, -1.0, shape)
    elif name == "conv_w":
        z = 0.3 * r.standard_normal(shape)
    elif name == "embed":
        z = r.standard_normal(shape)
    elif name.startswith(("w", "lm_head")):
        z = r.standard_normal(shape) / np.sqrt(shape[-2])
    else:
        z = 0.1 * r.standard_normal(shape)
    return z.astype(np.float32)


@pytest.fixture(scope="module")
def np_params():
    shapes = jax.eval_shape(lambda k: jax_model.init(k, JCFG),
                            jax.random.PRNGKey(0))
    return _randomize(jax.tree.map(lambda s: s, shapes),
                      np.random.default_rng(0))


def _batch(seed=1):
    """Token ids from a numpy seed; the labels are the tokens shifted by
    one, the last position -1."""
    toks = np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S),
                                                dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    return {"tokens": toks, "labels": labels}


def _xent_inputs():
    """S = 40 (not a multiple of the chunk 16), d 16, V 48, a fifth of
    the labels -1; a head of 3/sqrt(d) so the softcap of 30 acts."""
    d, V, Sx = 16, 48, 40
    r = np.random.default_rng(7)
    h = r.standard_normal((B, Sx, d)).astype(np.float32)
    w = (3.0 * r.standard_normal((d, V)) / np.sqrt(d)).astype(np.float32)
    y = r.integers(0, V, (B, Sx)).astype(np.int32)
    y[r.random((B, Sx)) < 0.2] = -1
    return h, w, y


def _scan_inputs():
    r = np.random.default_rng(8)
    a = r.uniform(0.4, 0.999, (2, 20, 8)).astype(np.float32)
    b, g = (r.standard_normal((2, 20, 8)).astype(np.float32)
            for _ in range(2))
    return a, b, g


def _layer_inputs():
    r = np.random.default_rng(9)
    return tuple(r.standard_normal((2, 24, CFG.d_model)).astype(np.float32)
                 for _ in range(2))


def _opt_tree(r):
    shapes = {"a": (5, 7), "b": [(3,), (2, 2, 4)]}
    return {"a": r.standard_normal(shapes["a"]).astype(np.float32),
            "b": [r.standard_normal(s).astype(np.float32)
                  for s in shapes["b"]]}


def _grads(params, r, n=STEPS):
    return [jax.tree.map(lambda p: (4.0 * r.standard_normal(p.shape)
                                    ).astype(np.float32), params)
            for _ in range(n)]


def _adam_inputs():
    """Params and STEPS gradients of norm ~20 (the clip of 1 acts)."""
    r = np.random.default_rng(3)
    params = _opt_tree(r)
    return params, _grads(params, r)


def _sgd_inputs():
    r = np.random.default_rng(6)
    params = _opt_tree(r)
    return params, _grads(params, r)


def _reference(params, batch, xent, scan, layer, adam, sgd):
    """Every reference value the tests check, as one program."""
    out = {}
    step = jax_build_train_step(JCFG, ApplyOptions(remat=False), lr=LR)

    def body(carry, i):
        p, o, loss = step(*carry, batch, i)
        return (p, o), (loss, o.mu)
    (p, _), (losses, mus) = jax.lax.scan(
        body, (params, jax_build_opt_init(JCFG)(params)), jnp.arange(STEPS))
    # the first step's gradient: Adam's first moment is (1 - b1) g
    out["train"] = (losses, p, jax.tree.map(lambda m: m[0] / 0.1, mus))
    h, w, y = xent
    for cap in CAPS:
        jcfg = JCFG.replace(vocab_size=w.shape[1], d_model=w.shape[0],
                            logit_softcap=cap)
        out[f"xent{cap}"] = jax.value_and_grad(
            lambda hh, ww: jax_tfm.chunked_xent({"lm_head": ww}, jcfg, hh, y,
                                                chunk=16),
            argnums=(0, 1))(h, w)
    a, b, g = scan
    out["scan"] = jax.vjp(rglru_scan_ref, a, b)[1](g)
    rec, x, ct = layer
    out["layer"] = jax.grad(lambda pp, xx: jnp.sum(jax_rglru.apply_rglru(
        pp, xx, conv_width=CFG.conv1d_width) * ct), argnums=(0, 1))(rec, x)
    bf = lambda t: jax.tree.map(lambda v: v.astype(jnp.bfloat16), t)
    ap, grads = adam
    ap = bf(ap)

    def adam_step(carry, g):
        carry = jadam_update(bf(g), carry[1], carry[0], **ADAM_KW)
        return carry, carry
    out["adam"] = jax.lax.scan(adam_step, (ap, jadam_init(ap, use_master=True)),
                               jax.tree.map(lambda *g: jnp.stack(g), *grads))[1]
    for momentum in MOMENTA:
        sp, grads = sgd
        st = jsgd_init(sp, momentum)
        for g in grads:
            sp, st = jsgd_update(g, st, sp, lr=1e-2, momentum=momentum)
        out[f"sgd{momentum}"] = sp
    steps = jnp.asarray(SCHED_STEPS)
    out["sched"] = [jax.vmap(s)(steps) for s in (
        jconstant(3e-4), jcosine_decay(3e-4, 20, warmup=3))]
    return out


@pytest.fixture(scope="module")
def ref(np_params):
    """:func:`_reference`, jitted once at O0 with LLVM's expensive passes
    off; bf16 rounded after every op, as the eager reference rounds it
    (only the Adam part has bf16 values)."""
    program = jax.jit(_reference, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
        "xla_allow_excess_precision": False})
    rec = jax.tree.map(lambda t: t[0], np_params["cycles"][0]["rec"])
    out = program(np_params, _batch(), _xent_inputs(), _scan_inputs(),
                  (rec,) + _layer_inputs(), _adam_inputs(), _sgd_inputs())
    return jax.tree.map(np.asarray, out)


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# chunked cross-entropy, the scan's backward, the RG-LRU layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", CAPS)
def test_chunked_xent_value_and_grads_match_jax(cap, ref):
    """S = 40 with chunk 16 shrinks to 10; labels of -1 are ignored.  fp32
    on both sides, sums over <= 80 kept positions in two orders: 1e-5 of
    the largest value."""
    h, w, y = _xent_inputs()
    want, (jdh, jdw) = ref[f"xent{cap}"]
    cfg = CFG.replace(vocab_size=w.shape[1], d_model=w.shape[0],
                      logit_softcap=cap)
    for remat in (True, False):
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        got = tfm.chunked_xent({"lm_head": tw}, cfg, th, torch.from_numpy(y),
                               chunk=16, remat=remat)
        got.backward()
        assert got.dtype == torch.float32 and got.dim() == 0
        _close_rel(got.item(), float(want), 1e-5)
        _close_rel(th.grad.numpy(), jdh, 1e-5)
        _close_rel(tw.grad.numpy(), jdw, 1e-5)


def test_scan_backward_matches_jax_grad(ref):
    """The plain reverse loop against ``jax.vjp`` of the reference's
    associative-scan oracle, fp32, 1e-5 of the largest gradient (two
    summation orders over 20 steps); the autograd function gives the
    plain loop's bits on a CPU tensor and launches nothing."""
    jda, jdb = ref["scan"]
    ta, tb, tg = map(torch.from_numpy, _scan_inputs())
    h = scan_ops.rglru_scan_plain(ta, tb)
    da, db = scan_ops.rglru_scan_backward_plain(ta, h, tg)
    _close_rel(da.numpy(), jda, 1e-5)
    _close_rel(db.numpy(), jdb, 1e-5)
    ta.requires_grad_()
    tb.requires_grad_()
    before = (scan_ops.rglru_scan.launches, scan_ops.rglru_scan.bwd_launches)
    out = scan_ops.RGLRUScan.apply(ta, tb)
    out.backward(tg)
    assert torch.equal(out.detach(), h)
    assert torch.equal(ta.grad, da) and torch.equal(tb.grad, db)
    assert (scan_ops.rglru_scan.launches,
            scan_ops.rglru_scan.bwd_launches) == before
    with pytest.raises(ValueError, match="one"):
        scan_ops.rglru_scan_backward(ta, h, tg[:, :4])


def test_apply_rglru_grads_match_jax(np_params, ref):
    """Every parameter's and the input's gradient of sum(out * ct) through
    the layer (the scan's backward among them) against ``jax.grad`` of
    the reference, fp32: 1e-4 of each leaf's largest (GEMMs of width 256
    and a 24-step recurrence, differentiated in two orders)."""
    jgp, jgx = ref["layer"]
    tp = {k: torch.from_numpy(v[0]).requires_grad_()
          for k, v in np_params["cycles"][0]["rec"].items()}
    x, ct = _layer_inputs()
    tx = torch.from_numpy(x).requires_grad_()
    torch.sum(rglru.apply_rglru(tp, tx, conv_width=CFG.conv1d_width)
              * torch.from_numpy(ct)).backward()
    _close_rel(tx.grad.numpy(), jgx, 1e-4)
    for k in tp:
        _close_rel(tp[k].grad.numpy(), jgp[k], 1e-4)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _to_bf16(tree):
    return tree_map(lambda t: t.to(torch.bfloat16), tree)


def _reversed_keys(tree):
    if isinstance(tree, dict):
        return {k: _reversed_keys(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, list):
        return [_reversed_keys(v) for v in tree]
    return tree


def _port_adam_run(params, grads, *, master, inplace, kw, clients=0,
                   state_keys_reversed=False):
    """STEPS Adam steps of the port; returns (params, state) after each
    step (copies).  ``clients``: a (C,) step, the leading axis of every
    leaf being C stacked clients.  ``state_keys_reversed``: the state's
    dicts hold their keys in the reverse of the params' order."""
    p = tree_map(lambda t: t.clone(), params)
    st = adam_init(_reversed_keys(p) if state_keys_reversed else p,
                   use_master=master)
    if clients:
        st = st._replace(step=torch.zeros((clients,), dtype=torch.int32))
    out = []
    for g in grads:
        g = tree_map(lambda t: t.to(tree_leaves(p)[0].dtype), g)
        if inplace:
            ids = [id(t) for t in tree_leaves((p, st))]
            assert adam_update_(g, st, p, **kw) is None
            assert [id(t) for t in tree_leaves((p, st))] == ids
        else:
            before = tree_map(lambda t: t.clone(), (p, st))
            new_p, new_st = adam_update(g, st, p, **kw)
            # functional: the inputs keep their values, the outputs are
            # new tensors
            for x, y in zip(tree_leaves((p, st)), tree_leaves(before)):
                assert torch.equal(x, y)
            assert not {id(t) for t in tree_leaves((new_p, new_st))} & {
                id(t) for t in tree_leaves((p, st))}
            p, st = new_p, new_st
        out.append(tree_map(lambda t: t.clone(), (p, st)))
    return out


def test_adam_master_clip_matches_jax(ref):
    """bf16 params over an fp32 master with the clip acting (grad norm
    ~20), 3 steps against the reference's ``adam_update``: the master and
    the fp32 moments within 1e-6 relative (the global norm summed in two
    orders), the bf16 params within one bf16 rounding step (2^-8
    relative: the two round equal fp32 values, and an ulp of difference
    upstream can cross a bf16 boundary), the step exact."""
    params, grads = _adam_inputs()
    port = _port_adam_run(_to_bf16(params_from_jax(params, CPU)),
                          [params_from_jax(g, CPU) for g in grads],
                          master=True, inplace=False, kw=dict(ADAM_KW))
    jsteps = [jax.tree.map(lambda t: t[i], ref["adam"]) for i in range(STEPS)]
    for (tp, ts), (jp, js) in zip(port, jsteps, strict=True):
        assert int(ts.step) == int(js.step)
        for tree_t, tree_j in ((ts.master, js.master), (ts.mu, js.mu),
                               (ts.nu, js.nu)):
            for got, want in zip(tree_leaves(tree_t),
                                 jax.tree.leaves(tree_j), strict=True):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                           atol=1e-7)
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp),
                             strict=True):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       rtol=2 ** -8, atol=1e-30)
    # params stay the master's cast
    for p, m in zip(tree_leaves(port[-1][0]), tree_leaves(port[-1][1].master)):
        assert torch.equal(p, m.to(torch.bfloat16))


@pytest.mark.parametrize("case", ["master_clip", "fp32", "stacked_clip",
                                  "state_keys_reversed"])
def test_adam_in_place_equals_functional_bitwise(case):
    """``adam_update_`` changes the tensors it is given and returns None;
    ``adam_update`` changes none of its inputs and returns new tensors
    (the FL trainers rely on it); both give the same bits.  On a stacked
    state each client's rows step on their own: a client whose
    gradients are zero keeps its params and has its step counted.  A
    state whose dicts hold their keys in another order than the params'
    steps each leaf with its own moments (the fp32 case's bits)."""
    r = np.random.default_rng(4)
    params = params_from_jax(_opt_tree(r), CPU)
    grads = [params_from_jax(g, CPU) for g in _grads(_opt_tree(r), r)]
    opts = {"master_clip": dict(master=True, kw=ADAM_KW),
            "fp32": dict(master=False, kw=dict(lr=1e-2)),
            "stacked_clip": dict(master=False, kw=ADAM_KW, clients=3),
            "state_keys_reversed": dict(master=False, kw=dict(lr=1e-2),
                                        state_keys_reversed=True)}[case]
    if case == "master_clip":
        params = _to_bf16(params)
    if case == "stacked_clip":              # 3 clients, the last idle
        params = tree_map(lambda t: torch.stack([t, 2 * t, t]), params)
        grads = [tree_map(lambda t: torch.stack([t, t, 0 * t]), g)
                 for g in grads]
    functional = _port_adam_run(params, grads, inplace=False, **opts)
    inplace = _port_adam_run(params, grads, inplace=True, **opts)
    for (fp, fs), (ip, is_) in zip(functional, inplace, strict=True):
        a, b = tree_leaves((fp, fs)), tree_leaves((ip, is_))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    if case == "state_keys_reversed":
        want = _port_adam_run(params, grads, inplace=True, master=False,
                              kw=dict(lr=1e-2))
        for x, y in zip(tree_leaves(inplace[-1][0]),
                        tree_leaves(want[-1][0]), strict=True):
            assert torch.equal(x, y)
    if case == "stacked_clip":
        fp, fs = functional[-1]
        assert fs.step.tolist() == [STEPS] * 3
        for x, x0 in zip(tree_leaves(fp), tree_leaves(params)):
            assert torch.equal(x[2], x0[2]) and not torch.equal(x[0], x0[0])


def test_adam_from_tree_round_trips(tmp_path):
    r = np.random.default_rng(5)
    params = _to_bf16(params_from_jax(_opt_tree(r), CPU))
    st = adam_init(params, use_master=True)
    adam_update_(tree_map(torch.ones_like, params), st, params, lr=1e-2)
    assert adam_from_tree(st) is st and adam_from_tree(None) is None
    path = str(tmp_path / "opt.npz")
    checkpoint.save(path, {"opt": st})
    tree, _ = checkpoint.load(path)
    back = adam_from_tree(tree["opt"], device=CPU)
    assert isinstance(back, AdamState) and int(back.step) == 1
    for x, y in zip(tree_leaves(back), tree_leaves(st)):
        assert x.shape == y.shape and torch.equal(x, y.to(x.dtype))
    plain = adam_from_tree(tuple(adam_init(params)))
    assert plain.master is None and int(plain.step) == 0


@pytest.mark.parametrize("momentum", MOMENTA)
def test_sgd_matches_jax(momentum, ref):
    """3 steps against the reference, fp32: 1e-6 relative."""
    params, grads = _sgd_inputs()
    tp = params_from_jax(params, CPU)
    ts = sgd_init(tp, momentum)
    assert (ts.momentum is None) == (momentum == 0.0)
    for g in grads:
        tp, ts = sgd_update(params_from_jax(g, CPU), ts, tp, lr=1e-2,
                            momentum=momentum)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(ref[f"sgd{momentum}"]),
                         strict=True):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_schedules_match_jax(ref):
    """Steps 0..25 of ``constant`` and of ``cosine_decay`` (warm-up 3,
    20 steps, floor 0.1) against the reference, fp32: 1e-6 relative
    (cos of two libraries)."""
    for tsched, want in zip((constant(3e-4), cosine_decay(3e-4, 20,
                                                          warmup=3)),
                            ref["sched"], strict=True):
        got = np.asarray([float(tsched(int(s))) for s in SCHED_STEPS])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(cosine_decay(1.0, 20, warmup=3)(0)) == 0.0


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fp32_run(np_params):
    """STEPS fp32 steps of the port's ``build_train_step`` on one batch
    from the reference's weights.  Returns the losses, the final params
    and the Adam state."""
    tp = params_from_jax(np_params, CPU)
    topt = build_opt_init(CFG)(tp)
    assert topt.master is None                  # fp32 params: no master
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    step = build_train_step(CFG, lr=LR)
    tlosses = []
    for i in range(STEPS):
        out_p, topt, loss = step(tp, topt, tb, i)
        assert out_p is tp                      # updated in place
        assert loss.dtype == torch.float32 and loss.dim() == 0
        tlosses.append(float(loss))
    return tlosses, tp, topt


def test_train_step_matches_jax(fp32_run, ref):
    """Losses within 1e-5 relative (fp32, summation orders only; measured
    2.1e-7); the loss falls.  Params after 3 steps, each leaf on its
    own: Adam's normalized step moves a parameter whose gradient is
    rounding noise by up to lr a step, in either direction in each
    package, so entries whose first reference gradient is below 1e-3 of
    their leaf's largest are held within 3 lr; every other entry within
    1e-5 (1% of lr); and at least 99.9% of each leaf within 1e-5
    (measured: every entry past 1e-5 had a gradient below 1.5e-4 of its
    leaf's largest, and no leaf had more than 0.007% of them)."""
    jlosses, jp, jgrad0 = ref["train"]
    tlosses, tp, topt = fp32_run
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    assert int(topt.step) == STEPS
    got = state_dict(tp)
    want, g0 = (state_dict(params_from_jax(t, CPU)) for t in (jp, jgrad0))
    assert got.keys() == want.keys() == g0.keys()
    for k in got:
        d = np.abs(_np(got[k]) - _np(want[k]))
        g = np.abs(_np(g0[k]))
        noise = g < 1e-3 * g.max()
        assert g.max() > 0, k
        assert d.max() <= 3 * LR, (k, d.max())
        assert d[~noise].max() <= 1e-5, (k, d[~noise].max())
        assert np.mean(d <= 1e-5) >= 0.999, (k, np.mean(d <= 1e-5))


def test_bf16_step_keeps_fp32_master(np_params, fp32_run):
    """bf16 params and activations over an fp32 master: after every step
    the master is fp32 and the params are its bf16 cast, bitwise; each
    loss within 3e-2 relative of the fp32 step's (bf16 activations over 3
    layers, and bf16 params after each update: measured 8e-5, 8.4e-3 and
    1.3e-2 over the 3 steps)."""
    cfg = CFG.replace(dtype="bfloat16", param_dtype="bfloat16")
    # the init's dtypes: bf16, log_lambda fp32
    tp = tree_map(lambda like, x: x.to(like.dtype),
                  model.init(cfg, torch.Generator(), device="cpu"),
                  params_from_jax(np_params, CPU))
    assert {p.dtype for p in tree_leaves(tp)} == {torch.bfloat16,
                                                  torch.float32}
    opt = build_opt_init(cfg)(tp)
    assert all(m.dtype == torch.float32 for m in tree_leaves(opt.master))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    step = build_train_step(cfg, lr=LR)
    flosses = fp32_run[0]
    for i in range(STEPS):
        tp, opt, loss = step(tp, opt, batch, i)
        assert abs(float(loss) - flosses[i]) <= 3e-2 * abs(flosses[i])
        for p, m in zip(tree_leaves(tp), tree_leaves(opt.master)):
            assert m.dtype == torch.float32
            assert torch.equal(p, m.to(p.dtype))


def test_input_specs_match_jax():
    for jshape, shape in ((J_TRAIN_4K, TRAIN_4K), (J_PREFILL_32K, PREFILL_32K),
                          (J_DECODE_32K, DECODE_32K)):
        assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
        for jcfg, cfg in ((JCFG, CFG), (jax_get_config(ARCH),
                                        get_config(ARCH))):
            want = jax_model.input_specs(jcfg, jshape)
            got = model.input_specs(cfg, shape)
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix(
                "torch.")) for k, v in got.items()} == {
                k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    small = dataclasses.replace(TRAIN_4K, seq_len=16, global_batch=2)
    x = model.make_inputs(CFG, small, gen)
    assert {k: (tuple(v.shape), v.dtype) for k, v in x.items()} == {
        k: (v.shape, v.dtype)
        for k, v in model.input_specs(CFG, small).items()}
    assert 0 <= int(x["tokens"].min()) and int(x["tokens"].max()) \
        < CFG.vocab_size
    # every one of the reference's architectures
    assert list_archs() == jax_list_archs()


def test_train_cli_trains_and_saves_a_reference_checkpoint(tmp_path):
    ckpt = str(tmp_path / "lm.npz")
    argv = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "32"]
    out = lm_train.main(argv + ["--device", "cpu", "--ckpt", ckpt])
    assert out["losses"][-1] < out["losses"][0]
    assert all(np.isfinite(out["losses"]))
    tree, meta = checkpoint.load(ckpt)
    jtree, jmeta = jax_checkpoint.load(ckpt)
    assert meta == jmeta == {"arch": CFG.name, "steps": 3,
                             "final_loss": out["losses"][-1]}
    got, want = state_dict(params_from_jax(tree, CPU)), \
        state_dict(params_from_jax(jtree, CPU))
    assert got.keys() == want.keys() and len(got) == len(state_dict(
        model.init(CFG, torch.Generator(), device="cpu")))
    assert all(torch.equal(got[k], want[k]) for k in got)
    with pytest.raises(NotImplementedError, match="A.13"):
        lm_train.main(argv + ["--device", "cpu", "--full"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lm_train.main(argv)
