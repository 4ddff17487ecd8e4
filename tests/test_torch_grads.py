"""Gradients of the port's differentiable kernel wrappers against
``jax.vjp`` of the JAX package's ops.

Each op runs on numpy-seeded inputs with a numpy-seeded cotangent.  On
the CPU the wrappers' forwards run the kernels' plain versions, and
their backwards are the very formulas the card runs: dx of the masked
matmul through the matmul wrapper on ``w.T`` with the masks swapped, the
attention backward as a dense recompute, the group sum of squares as
``2 w g``.  The reference runs its ``xla`` route and, at one 128-aligned
shape per op, its ``pallas`` route in interpret mode (its ``custom_vjp``
backwards).  fp32 throughout; tolerances are stated per test.

The segmented group sum of squares and Omega run on ``SMOKE_UNET`` with
non-degenerate numpy-seeded weights against the reference's
``group_sq_norms``, ``omega`` and its ``jax.grad`` (``ref`` backend, one
small ``jit``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_UNET as JAX_SMOKE
from repro.core.pruning import build_groups as jbuild_groups
from repro.core.pruning import depth_lambdas as jdepth_lambdas
from repro.core.pruning import group_sq_norms as jgroup_sq_norms
from repro.core.pruning import omega as jomega
from repro.models import ops as jops
from repro.models.unet import init_unet as jinit_unet
from repro_torch.configs import SMOKE_UNET
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import (depth_lambdas, member_table, omega,
                                      sq_norms, unet_groups)
from repro_torch.kernels.block_masked_matmul import ops as bmm
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import ops
from repro_torch.tree import tree_leaves

ATOL = 1e-5
# the reference's programs as one jit each at XLA's O0 with LLVM's
# expensive passes off: run eagerly, JAX compiles every op on its own
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True,
      # XLA's loop emitters: less compile CPU, the same graph
      "xla_cpu_use_fusion_emitters": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch from oversubscribing the cores (the
    small shapes here gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _masks(r, K, N, block_masked):
    cm = (r.random(N) > 0.44).astype(np.float32)
    rm = (r.random(K) > 0.3).astype(np.float32)
    if block_masked:                      # one fully masked 64-column block
        cm[:64] = 0.0
    return cm, rm


def _mm_case(M, K, N, masked, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K), np.float32)
    w = (r.standard_normal((K, N), np.float32) / np.sqrt(K)).astype(
        np.float32)
    g = r.standard_normal((M, N), np.float32)
    cm, rm = _masks(r, K, N, block_masked=N >= 128) if masked else (None,
                                                                    None)
    return x, w, g, cm, rm


def _jax_mm_vjp(x, w, g, cm, rm, backend):
    def value_and_vjp(x, w, g, cm, rm):
        y, vjp = jax.vjp(lambda x_, w_: jops.masked_matmul(
            x_, w_, cm, rm, backend=backend), x, w)
        return (y,) + vjp(g)
    return tuple(np.asarray(t) for t in jax.jit(
        value_and_vjp, compiler_options=O0)(x, w, g, cm, rm))


def _port_mm_grads(x, w, g, cm, rm):
    xt, wt = _t(x, True), _t(w, True)
    y = ops.masked_matmul(xt, wt, None if cm is None else _t(cm),
                          None if rm is None else _t(rm))
    y.backward(_t(g))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("M,K,N,masked,backend", [
    (64, 48, 80, False, "xla"),
    (96, 72, 144, True, "xla"),
    (128, 256, 128, False, "pallas"),
    (128, 128, 256, True, "pallas"),
])
def test_masked_matmul_grads_match_jax(M, K, N, masked, backend):
    """atol 1e-5: fp32 products over K <= 256 terms of O(1) values."""
    x, w, g, cm, rm = _mm_case(M, K, N, masked)
    want = _jax_mm_vjp(x, w, g, cm, rm, backend)
    got = _port_mm_grads(x, w, g, cm, rm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL)
    if masked:
        dw = got[2]
        # pruned rows and columns get exactly zero gradient, the fully
        # masked 64-column block included
        assert np.all(dw[:, cm == 0] == 0.0)
        assert np.all(dw[rm == 0, :] == 0.0)
        assert np.all(dw[:, :64] == 0.0)


def test_masked_matmul_dx_runs_the_matmul_wrapper_on_w_transposed(
        monkeypatch):
    """The backward's dx is the matmul wrapper itself, launched on
    (g, w.T) with the row mask as column mask and the column mask as row
    mask, and marked as a dx launch; w.T is read in place from w
    (``trans_b``), not copied."""
    x, w, g, cm, rm = _mm_case(32, 24, 40, masked=True)
    calls = []
    real = bmm.block_masked_matmul

    def spy(a, b, col_mask=None, row_mask=None, *, role="fwd",
            trans_b=False):
        calls.append((tuple(a.shape), tuple((b.t() if trans_b else b).shape),
                      col_mask, row_mask, role, trans_b, b))
        return real(a, b, col_mask, row_mask, role=role, trans_b=trans_b)

    monkeypatch.setattr(bmm, "block_masked_matmul", spy)
    _port_mm_grads(x, w, g, cm, rm)
    assert [c[4] for c in calls] == ["fwd", "dx"]
    (fa_, fb, fcm, frm, _, ft, fw), (da, db, dcm, drm, _, dt, dw) = calls
    assert (fa_, fb) == ((32, 24), (24, 40))
    assert (da, db) == ((32, 40), (40, 24))
    assert not ft and dt and dw.data_ptr() == fw.data_ptr()
    np.testing.assert_array_equal(dcm.numpy(), rm)
    np.testing.assert_array_equal(drm.numpy(), cm)
    np.testing.assert_array_equal(fcm.numpy(), cm)


def test_masked_matmul_skips_dx_when_x_needs_no_grad(monkeypatch):
    x, w, g, _, _ = _mm_case(16, 8, 12, masked=False)
    roles = []
    real = bmm.block_masked_matmul
    monkeypatch.setattr(bmm, "block_masked_matmul",
                        lambda *a, role="fwd", **k: roles.append(role)
                        or real(*a, role=role, **k))
    wt = _t(w, True)
    ops.masked_matmul(_t(x), wt).backward(_t(g))
    assert roles == ["fwd"] and wt.grad is not None


def _attn_case(B, S, H, Hkv, hd, seed=1):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, S, H, hd), np.float32)
    k = r.standard_normal((B, S, Hkv, hd), np.float32)
    v = r.standard_normal((B, S, Hkv, hd), np.float32)
    g = r.standard_normal((B, S, H, hd), np.float32)
    return q, k, v, g


@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window,backend", [
    (2, 64, 1, 1, 32, False, 0, "xla"),        # the U-Net's case
    (2, 48, 1, 1, 144, False, 0, "xla"),       # hd after pruning
    (1, 40, 2, 2, 16, True, 0, "xla"),
    (1, 40, 2, 1, 16, True, 12, "xla"),        # windowed, GQA
    (1, 128, 1, 1, 64, False, 0, "pallas"),
])
def test_attention_grads_match_jax(B, S, H, Hkv, hd, causal, window,
                                   backend):
    """atol 1e-5: fp32 softmax over <= 128 keys of O(1) scores."""
    q, k, v, g = _attn_case(B, S, H, Hkv, hd)

    def value_and_vjp(a, b, c, ct):
        y, vjp = jax.vjp(lambda a, b, c: jops.attention(
            a, b, c, causal=causal, window=window, backend=backend), a, b, c)
        return (y,) + vjp(ct)
    want = tuple(np.asarray(x) for x in jax.jit(
        value_and_vjp, compiler_options=O0)(q, k, v, g))
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = ops.attention(qt, kt, vt, causal=causal, window=window)
    out.backward(_t(g))
    got = (out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(),
           vt.grad.numpy())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_attention_backward_does_not_call_the_plain_forward(monkeypatch):
    q, k, v, g = _attn_case(1, 32, 1, 1, 16)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = ops.attention(qt, kt, vt)

    def banned(*a, **kw):
        raise AssertionError("the backward called flash_attention_plain")

    monkeypatch.setattr(fa, "flash_attention_plain", banned)
    out.backward(_t(g))
    assert qt.grad is not None and torch.isfinite(qt.grad).all()


@pytest.mark.parametrize("K,G,C,backend", [(36, 16, 1, "xla"),
                                           (9, 24, 3, "xla"),
                                           (128, 8, 16, "pallas")])
def test_group_sq_norms_grads_match_jax(K, G, C, backend):
    """Forward rtol 1e-6 (sums of K*C squares); gradient 2 w g exactly
    as formulated, atol 1e-6."""
    r = np.random.default_rng(2)
    w = r.standard_normal((K, G * C), np.float32)
    g = r.standard_normal(G).astype(np.float32)
    def value_and_vjp(a, ct):
        y, vjp = jax.vjp(
            lambda a: jops.group_sq_norms_2d(a, G, backend=backend), a)
        return (y,) + vjp(ct)
    y, dw = jax.jit(value_and_vjp, compiler_options=O0)(w, g)
    wt = _t(w, True)
    out = ops.group_sq_norms_2d(wt, G)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), atol=1e-6)


def _randomize(tree, r):
    """Weights at 1/sqrt(fan_in), norm scales near 1, small biases."""
    if isinstance(tree, dict):
        return {k: _randomize(v, r) if isinstance(v, (dict, list))
                else _leaf(k, v.shape, r) for k, v in tree.items()}
    return [_randomize(v, r) for v in tree]


def _leaf(name, shape, r):
    z = r.standard_normal(shape).astype(np.float32)
    if name == "w":
        return z / np.float32(np.sqrt(np.prod(shape[:-1])))
    return 1.0 + 0.1 * z if name == "scale" else 0.1 * z


def _by_path(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree of either package."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _by_path(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _by_path(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_segmented_sq_norms_and_omega_match_jax():
    """Every member tensor covered whole; each group's sums within 1e-6
    of that group's largest sum; Omega within 1e-6 of itself; every
    leaf's gradient within 1e-6 of the largest gradient of any leaf."""
    shapes = jax.eval_shape(lambda k: jinit_unet(k, JAX_SMOKE),
                            jax.random.PRNGKey(0))
    np_params = _randomize(shapes, np.random.default_rng(5))
    jp = jax.tree.map(jnp.asarray, np_params)
    jg = jbuild_groups(JAX_SMOKE, jp)
    jl = jdepth_lambdas(jg, 1e-3)

    def reference(p):
        sq = [jgroup_sq_norms(p, g, backend="ref") for g in jg]
        value, grad = jax.value_and_grad(
            lambda q: jomega(q, jg, jl, backend="ref"))(p)
        return sq, value, grad

    want_sq, want, jgrad = jax.jit(reference, compiler_options=O0)(jp)

    tp = params_from_jax(np_params, torch.device("cpu"))
    tg = unet_groups(SMOKE_UNET, tp)
    assert [g.name for g in tg] == [g.name for g in jg]
    for v in tree_leaves(tp):
        v.requires_grad_()
    tensors, tab = member_table(tp, tg)
    # every member tensor is owned whole, so its gradient needs no zeros
    assert len(tab.covered) == len(tensors) and all(tab.covered)
    sq = sq_norms(tp, tg)[0].detach().numpy()
    assert sq.shape == (sum(g.size for g in tg),)
    for g, (base, size, _, _), ref in zip(tg, tab.groups, want_sq):
        ref = np.asarray(ref)
        np.testing.assert_allclose(sq[base:base + size], ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=g.name)
    got = omega(tp, tg, depth_lambdas(tg, 1e-3))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    jg_by = {k: np.asarray(v) for k, v in _by_path(jgrad).items()}
    scale = max(np.abs(v).max() for v in jg_by.values())
    tp_by = _by_path(tp)
    assert tp_by.keys() == jg_by.keys()
    for k, leaf in tp_by.items():
        g = np.zeros(leaf.shape, np.float32) if leaf.grad is None \
            else leaf.grad.numpy()
        np.testing.assert_allclose(g, jg_by[k], rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
