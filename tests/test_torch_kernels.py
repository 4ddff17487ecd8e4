"""The port's kernel modules against the JAX kernels.

Each plain PyTorch version is held against the Pallas kernel run in
interpret mode (tile-aligned shapes, as ``tests/test_kernels.py`` runs
it) and against the kernel's ``ref.py`` oracle (any shape).  On CPU
tensors the wrappers run the plain version and count no launch; the
CUDA kernels themselves are checked on the card by ``chip_smoke.py``.
Inputs come from a numpy seed and go to both packages as numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_masked_matmul.block_masked_matmul import (
    block_masked_matmul as jax_bmm)
from repro.kernels.block_masked_matmul.ref import block_masked_matmul_ref
from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.group_l2_norms.group_l2_norms import group_l2_norms
from repro.kernels.group_l2_norms.ref import group_l2_norms_ref
from repro_torch.kernels import build
from repro_torch.kernels.block_masked_matmul import ops as bmm
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.group_l2_norms import ops as gl2

# fp32 as tests/test_kernels.py; bf16 outputs round to 8 mantissa bits
# (plus an rtol for accumulation-order rounding over large K)
TOL = {"float32": dict(atol=1e-4, rtol=0.0), "bfloat16": dict(atol=0.15,
                                                              rtol=1e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one intra-op
    thread per process keeps torch from oversubscribing the cores (the
    small shapes here gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, M, K, N, ratio, dtype):
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, K), np.float32)
    w = r.standard_normal((K, N), np.float32)
    cm = (r.random(N) >= ratio).astype(np.float32)
    rm = (r.random(K) >= ratio / 2).astype(np.float32)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    return (tx, tw, torch.from_numpy(cm), torch.from_numpy(rm)), \
        (jx, jw, jnp.asarray(cm), jnp.asarray(rm))


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **TOL[dtype])


@pytest.mark.parametrize("M,K,N,dtype,ratio", [
    (128, 128, 128, "float32", 0.0),
    (256, 384, 128, "float32", 0.44),
    (128, 256, 512, "bfloat16", 0.9),
])
def test_block_masked_matmul_plain_matches_pallas(M, K, N, dtype, ratio):
    t, j = _inputs(0, M, K, N, ratio, dtype)
    got = bmm.block_masked_matmul_plain(*t)
    assert got.dtype == t[0].dtype
    _close(got, jax_bmm(*j, interpret=True), dtype)


@pytest.mark.parametrize("M,K,N", [(8, 27, 3), (8, 128, 512), (130, 77, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_masked_matmul_plain_matches_ref_any_shape(M, K, N, dtype):
    t, j = _inputs(1, M, K, N, 0.44, dtype)
    _close(bmm.block_masked_matmul_plain(*t), block_masked_matmul_ref(*j),
           dtype)


def test_block_masked_matmul_wrapper_on_cpu_runs_plain_uncounted():
    t, _ = _inputs(2, 64, 96, 40, 0.44, "float32")
    before = bmm.block_masked_matmul.launches
    shapes = dict(bmm.block_masked_matmul.shapes)
    got = bmm.block_masked_matmul(*t)
    assert torch.equal(got, bmm.block_masked_matmul_plain(*t))
    assert torch.equal(bmm.block_masked_matmul(t[0], t[1]),
                       bmm.block_masked_matmul_plain(t[0], t[1]))
    assert bmm.block_masked_matmul.launches == before
    assert dict(bmm.block_masked_matmul.shapes) == shapes


def test_block_masked_matmul_masked_block_is_exact_zero():
    """A fully masked N-block gives exactly zero output columns
    (the counterpart of tests/test_kernels.py:38)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((128, 128), np.float32))
    w = torch.from_numpy(r.standard_normal((128, 256), np.float32))
    cm = torch.cat([torch.zeros(128), torch.ones(128)])
    got = bmm.block_masked_matmul(x, w, cm, torch.ones(128))
    assert float(got[:, :128].abs().max()) == 0.0
    assert float(got[:, 128:].abs().max()) > 0.0


def _qkv(seed, BH, S, hd, dtype):
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal((BH, S, hd), np.float32) for _ in range(3)]
    return ([torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs],
            [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_flash_attention_plain_matches_pallas(causal, window):
    t, j = _qkv(4, 2, 128, 64, "float32")
    got = fa.flash_attention_plain(*t, causal=causal, window=window)
    want = flash_attention_bhsd(*j, causal=causal, window=window,
                                interpret=True)
    # the streaming softmax rescales in another order: 2e-3 as
    # tests/test_kernels.py
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("BH,S,hd,dtype", [(8, 16, 256, "float32"),
                                           (2, 40, 144, "float32"),
                                           (2, 40, 144, "bfloat16")])
def test_flash_attention_plain_matches_ref_any_shape(BH, S, hd, dtype):
    t, j = _qkv(5, BH, S, hd, dtype)
    got = fa.flash_attention_plain(*t, causal=False)
    want = flash_attention_ref(*j, causal=False)
    atol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_flash_attention_wrapper_on_cpu_runs_plain_uncounted():
    t, _ = _qkv(6, 2, 16, 144, "float32")
    before = fa.flash_attention_bhsd.launches
    shapes = dict(fa.flash_attention_bhsd.shapes)
    got = fa.flash_attention_bhsd(*t, causal=False)
    assert torch.equal(got, fa.flash_attention_plain(*t, causal=False))
    assert fa.flash_attention_bhsd.launches == before
    assert dict(fa.flash_attention_bhsd.shapes) == shapes


@pytest.mark.parametrize("K,G,C", [(128, 8, 64), (64, 4, 128)])
def test_group_l2_norms_plain_matches_pallas(K, G, C):
    w = np.random.default_rng(7).standard_normal((K, G * C), np.float32)
    got = gl2.group_l2_norms_plain(torch.from_numpy(w), G)
    want = group_l2_norms(jnp.asarray(w), G, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("K,N,G", [(1152, 256, 256), (1, 128, 128),
                                   (27, 12, 3)])
def test_group_l2_norms_wrapper_matches_ref(K, N, G):
    w = np.random.default_rng(8).standard_normal((K, N), np.float32)
    before = gl2.group_l2_norms.launches
    shapes = dict(gl2.group_l2_norms.shapes)
    got = gl2.group_l2_norms(torch.from_numpy(w), G)
    assert gl2.group_l2_norms.launches == before
    assert dict(gl2.group_l2_norms.shapes) == shapes
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(group_l2_norms_ref(jnp.asarray(w),
                                                             G)), rtol=1e-5)


def test_group_l2_norms_rejects_uneven_groups():
    with pytest.raises(ValueError, match="column groups"):
        gl2.group_l2_norms(torch.zeros(4, 10), 3)


def test_build_sources_and_library_key(tmp_path):
    names = sorted(p.name for p in build.sources())
    assert names == ["block_masked_matmul.cu", "flash_attention.cu",
                     "group_l2_norms.cu", "rglru_scan.cu"]
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    assert set(build.SIGNATURES) >= {"bmm_launch", "flash_attn_launch",
                                     "group_l2_fwd_launch",
                                     "group_l2_bwd_launch",
                                     "rglru_scan_launch"}
    # the key covers every file under each csrc/ (an edited header
    # rebuilds) and the flags (an added include path or link library)
    csrc = tmp_path / "kern" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "kern.cu").write_text('#include "tile.cuh"\n')
    (csrc / "tile.cuh").write_text("constexpr int T = 64;\n")
    key = build.library_path(tmp_path)
    assert build.library_path(tmp_path) == key
    (csrc / "tile.cuh").write_text("constexpr int T = 128;\n")
    assert build.library_path(tmp_path) != key
    key = build.library_path(tmp_path)
    assert build.library_path(tmp_path, (*build.NVCC_FLAGS, "-Iinclude")) \
        != key
