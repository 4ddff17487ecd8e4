"""The port's ops layer, GroupNorm, embeddings and DDIM step against the
JAX package's ``xla`` and ``ref`` backends.

Inputs come from a numpy seed and reach both packages as numpy.  fp32
comparisons use atol 1e-5, as ``tests/test_ops_backends.py`` does, unless
a case states another tolerance and its reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion.ddim import ddim_step as jax_ddim_step
from repro.diffusion.ddim import ddim_timesteps as jax_ddim_timesteps
from repro.diffusion.schedule import linear_schedule as jax_schedule
from repro.models import ops as jops
from repro.models.common import group_norm as jax_group_norm
from repro.models.common import sinusoidal_embedding as jax_sinusoidal
from repro_torch.diffusion.ddim import ddim_step, ddim_timesteps
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.models import ops
from repro_torch.models.common import group_norm, sinusoidal_embedding
from repro_torch.models.unet import upsample2x

ATOL = 1e-5
BACKENDS = ("xla", "ref")
# the reference's calls run as one program each, at XLA's O0 with LLVM's
# expensive passes off: run eagerly, JAX compiles each op on its own
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True}


def _ref(fn, *args):
    """The reference's ``fn(*args)`` as one program (array arguments;
    static ones are closed over)."""
    return jax.jit(fn, compiler_options=O0)(*args)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch from oversubscribing the cores (the
    small shapes here gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _conv_p(r, kh, kw, cin, cout):
    return {"w": (r.standard_normal((kh, kw, cin, cout), np.float32)
                  / np.sqrt(kh * kw * cin)).astype(np.float32),
            "b": r.standard_normal(cout).astype(np.float32)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k,stride,cin,cout", [(3, 1, 16, 32), (3, 2, 16, 16),
                                               (1, 1, 16, 48), (3, 1, 3, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_conv_matches_jax(backend, k, stride, cin, cout, masked):
    r = _rng(0)
    x = r.standard_normal((2, 8, 8, cin), np.float32)
    p = _conv_p(r, k, k, cin, cout)
    cm = rm = None
    if masked:
        cm = (r.random(cout) > 0.44).astype(np.float32)
        rm = (r.random(cin) > 0.44).astype(np.float32)
    want = _ref(lambda p_, x_, cm_, rm_: jops.conv(
        p_, x_, stride=stride, backend=backend, col_mask=cm_, row_mask=rm_),
        p, x, cm, rm)
    tp = {k_: _t(v) for k_, v in p.items()}
    got = ops.conv(tp, _t(x), stride=stride,
                   col_mask=None if cm is None else _t(cm),
                   row_mask=None if rm is None else _t(rm))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if masked:                  # the host-mask (gather) route agrees too
        host = ops.conv(tp, _t(x), stride=stride, col_mask=cm, row_mask=rm)
        np.testing.assert_allclose(host.numpy(), np.asarray(want), atol=ATOL)


def test_same_pads_stride2_is_asymmetric():
    assert ops.same_pads(32, 3, 2) == (16, (0, 1))
    assert ops.same_pads(16, 3, 1) == (16, (1, 1))
    assert ops.same_pads(16, 1, 1) == (16, (0, 0))


@pytest.mark.parametrize("ratio", [0.0, 0.44, 1.0])
def test_masked_matmul_host_vs_device_masks(ratio):
    """Host numpy masks (gather -> GEMM -> scatter) equal device masks
    (multiply by zero) and the JAX static route, up to reduction order."""
    r = _rng(1)
    x = r.standard_normal((3, 5, 40), np.float32)
    w = r.standard_normal((40, 24), np.float32)
    cm = (r.random(24) >= ratio).astype(np.float32)
    rm = (r.random(40) >= ratio / 2).astype(np.float32)
    dev = ops.masked_matmul(_t(x), _t(w), _t(cm), _t(rm))
    host = ops.masked_matmul(_t(x), _t(w), cm, rm)
    # host masks: the reference's static route, closed over
    want = _ref(lambda x_, w_: jops.masked_matmul(x_, w_, cm, rm,
                                                  backend="xla"), x, w)
    assert dev.shape == host.shape == (3, 5, 24)
    np.testing.assert_allclose(host.numpy(), dev.numpy(), atol=ATOL)
    np.testing.assert_allclose(host.numpy(), np.asarray(want), atol=ATOL)
    if ratio == 1.0:
        assert float(host.abs().max()) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_dense_col_mask_matches_jax(backend):
    r = _rng(2)
    x = r.standard_normal((4, 32), np.float32)
    p = {"w": r.standard_normal((32, 20), np.float32),
         "b": r.standard_normal(20).astype(np.float32)}
    cm = (r.random(20) > 0.5).astype(np.float32)
    want = _ref(lambda p_, x_, cm_: jops.dense(p_, x_, backend=backend,
                                               col_mask=cm_), p, x, cm)
    tp = {k: _t(v) for k, v in p.items()}
    for mask in (_t(cm), cm):
        np.testing.assert_allclose(
            ops.dense(tp, _t(x), col_mask=mask).numpy(), np.asarray(want),
            atol=ATOL)


def test_bf16_gemm_casts_activations():
    """bf16 weights pull fp32 activations into bf16 at the GEMM, as the
    reference's _gemm_cast does; the result stays within bf16 rounding
    (8 mantissa bits: 2e-2 relative) of the JAX bf16 route."""
    r = _rng(3)
    x = r.standard_normal((16, 64), np.float32)
    w = r.standard_normal((64, 32), np.float32) / 8
    tw = ops.cast_floats({"w": _t(w), "n": torch.arange(3)}, torch.bfloat16)
    assert tw["w"].dtype == torch.bfloat16 and tw["n"].dtype == torch.int64
    got = ops.masked_matmul(_t(x), tw["w"])
    assert got.dtype == torch.bfloat16
    want = _ref(lambda x_, w_: jops.masked_matmul(x_, w_, backend="xla"),
                x, jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", [
    (2, 16, 1, 1, 144, False, 0),      # U-Net mid block after pruning
    (2, 24, 4, 2, 32, True, 0),        # GQA expansion
    (2, 24, 2, 2, 16, True, 8),        # sliding window
])
def test_attention_matches_jax(backend, B, S, H, Hkv, hd, causal, window):
    r = _rng(4)
    q = r.standard_normal((B, S, H, hd), np.float32)
    k = r.standard_normal((B, S, Hkv, hd), np.float32)
    v = r.standard_normal((B, S, Hkv, hd), np.float32)
    want = _ref(lambda q_, k_, v_: jops.attention(
        q_, k_, v_, causal=causal, window=window, backend=backend), q, k, v)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_group_sq_norms_matches_jax(backend):
    w = _rng(5).standard_normal((288, 64), np.float32)
    want = _ref(lambda w_: jops.group_sq_norms_2d(w_, 16, backend=backend),
                w)
    got = ops.group_sq_norms_2d(_t(w), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("c", [32, 64, 144, 3])
def test_group_norm_matches_jax(c):
    """Including c=144 (24 groups after pruning), which
    torch.nn.GroupNorm(32, 144) refuses."""
    r = _rng(6)
    x = r.standard_normal((2, 4, 4, c), np.float32) * 3 + 1
    s = r.standard_normal(c).astype(np.float32)
    b = r.standard_normal(c).astype(np.float32)
    want = _ref(jax_group_norm, x, s, b)
    got = group_norm(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_sinusoidal_embedding_matches_jax():
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 33, 128):
        want = _ref(lambda t_: jax_sinusoidal(t_, dim), t)
        got = sinusoidal_embedding(_t(t), dim)
        assert got.shape == want.shape
        # cos/sin of arguments up to 999 rad: one float32 ulp of the
        # argument is 6e-5, so the tolerance scales with t
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_upsample_matches_jax_nearest_resize():
    x = _rng(7).standard_normal((2, 4, 4, 3), np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 8, 8, 3), "nearest")
    np.testing.assert_array_equal(upsample2x(_t(x)).numpy(), np.asarray(want))


@pytest.mark.parametrize("T,S", [(1000, 10), (1000, 1), (1000, 600),
                                 (100, 7), (100, 100)])
def test_ddim_timesteps_match_jax(T, S):
    np.testing.assert_array_equal(ddim_timesteps(T, S),
                                  np.asarray(jax_ddim_timesteps(T, S)))


def test_ddim_timesteps_rejects_out_of_range():
    with pytest.raises(ValueError):
        ddim_timesteps(100, 0)


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_step_matches_jax(eta):
    r = _rng(8)
    x = r.standard_normal((3, 4, 4, 3), np.float32)
    eps = r.standard_normal((3, 4, 4, 3), np.float32)
    z = r.standard_normal((3, 4, 4, 3), np.float32)
    t = np.array([999, 500, 10], np.int64)
    tp = np.array([899, 400, -1], np.int64)
    want = _ref(lambda x_, t_, tp_, eps_, z_: jax_ddim_step(
        x_, t_, tp_, eps_, jax_schedule(1000), eta=eta, z=z_), x,
        t.astype(np.int32), tp.astype(np.int32), eps, z if eta else None)
    got = ddim_step(_t(x), _t(t), _t(tp), _t(eps),
                    linear_schedule(1000, device="cpu"), eta=eta,
                    z=_t(z) if eta else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
