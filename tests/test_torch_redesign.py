"""What the H100 kernels' designs decide in Python, checked on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py``); here:

- the masked matmul's launch plan (block tile and split-K) for the
  shapes the training and serving paths launch, and ragged ones;
- the bf16 attention kernel's rounding, emulated in plain PyTorch tile
  by tile as the kernel computes (fp32 scores from bf16 inputs, P
  rounded to bf16 for P V, l summed from the fp32 P), against the JAX
  kernel in interpret mode within the bf16 tolerance that
  ``chip_smoke.py`` holds the kernel to (1e-2 x max|ref|);
- which attention kernel a launch takes;
- the segmented group-L2 launch's table on ``SMOKE_UNET`` with
  non-degenerate numpy-seeded weights (``test_torch_grads.py`` holds
  its sums and gradients against the reference): cached per shape and
  dtype, and the kernel's work items, partials and pass-2 order
  emulated in numpy from the device descriptor (every owned element read
  once; the sums within 1e-6 of the largest, the backward bitwise);
- which scan kernel a launch takes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd
from repro_torch.configs import SMOKE_UNET
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import member_table, unet_groups
from repro_torch.kernels.block_masked_matmul import ops as bmm
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.group_l2_norms import ops as gl2
from repro_torch.kernels.rglru_scan import ops as scan
from repro_torch.models.unet import init_unet
from repro_torch.tree import tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process, as the other port files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("M,K,N", [
    (512, 4608, 256), (8, 512, 256), (128, 4608, 144), (8, 128, 512),
    (2048, 4608, 256), (8192, 4608, 256), (32768, 2304, 256),
    (32768, 3, 1152), (32768, 1152, 3), (8192, 27, 128), (32, 512, 72),
    (1000, 999, 77), (8, 27, 3), (1, 1, 1), (5, 0, 7), (130, 77, 65)])
def test_matmul_plan_covers_k_and_fills_the_card(M, K, N):
    p = bmm.plan(M, K, N)
    steps = math.ceil(K / p.depth())
    assert p.bm in (64, 128) and p.bn in (64, 128)
    assert 1 <= p.splits <= max(bmm.SPLITS) and p.per >= 1
    # the slices cover every k step, and the last one is not empty
    assert p.splits * p.per >= steps
    assert (p.splits - 1) * p.per < max(steps, 1)
    tiles = math.ceil(M / p.bm) * math.ceil(N / p.bn)
    if tiles >= bmm.SMS * bmm.SLOTS[p.bm, p.bn]:   # every SM's slots full
        assert p.splits == 1
    assert p.blocks(M, N) == tiles * p.splits
    if (M, K, N) == (512, 4608, 256):       # 32 output tiles, K 4608
        assert p.splits > 1 and p.blocks(M, N) >= bmm.SMS
    if M <= 64:                             # serving's M = 8: no 128-row pad
        assert p.bm == 64


def test_matmul_trans_b_on_cpu_is_w_transposed():
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((9, 13), np.float32))
    w = torch.from_numpy(r.standard_normal((13, 6), np.float32))
    cm = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    rm = torch.from_numpy((r.random(13) > 0.3).astype(np.float32))
    got = bmm.block_masked_matmul(x, w.t().contiguous(), cm, rm,
                                  trans_b=True)
    assert torch.equal(got, bmm.block_masked_matmul_plain(x, w, cm, rm))


def emulate_bf16_kernel(q, k, v, *, causal, window, bkv=64):
    """The bf16 wgmma kernel's arithmetic on (BH, S, hd) bf16 tensors:
    exact products of bf16 values summed in fp32, the streaming softmax
    over key tiles of ``bkv`` in base 2, P rounded to bf16 before P V,
    l from the fp32 P, the output rounded to bf16."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, hd))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, bkv):
        kpos = torch.arange(k0, min(k0 + bkv, Skv))[None, :]
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + bkv]) * scale_log2
        ok = torch.ones_like(s[0], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= (qpos - kpos) < window
        s = torch.where(ok[None], s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pb = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", pb,
                                         vf[:, k0:k0 + bkv])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def test_bf16_kernel_rounding_fits_the_tolerance():
    BH, S, hd, window = 2, 512, 256, 256
    r = np.random.default_rng(11)
    arrs = [r.standard_normal((BH, S, hd), np.float32) for _ in range(3)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    got = emulate_bf16_kernel(*t, causal=True, window=window)
    want = np.asarray(flash_attention_bhsd(*j, causal=True, window=window,
                                           interpret=True), np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max()
    # and the plain version, which chip_smoke.py compares the kernel with
    plain = fa.flash_attention_plain(*t, causal=True, window=window)
    assert float((got.float() - plain.float()).abs().max()) \
        <= 1e-2 * float(plain.float().abs().max())


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 144, "wgmma"),
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 4, "simt"),
    (torch.bfloat16, 100, "simt"),
    (torch.float32, 256, "simt"), (torch.float32, 144, "simt")])
def test_attention_variant(dtype, hd, want):
    assert fa.variant(dtype, hd) == want


# ---------------------------------------------------------------------------
# group-L2: one segmented launch per evaluation
# ---------------------------------------------------------------------------

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


@pytest.fixture(scope="module")
def smoke():
    """(torch params, torch groups) of SMOKE_UNET."""
    cpu = torch.device("cpu")
    shapes = init_unet(SMOKE_UNET, torch.Generator().manual_seed(0),
                       device=cpu)
    tp = params_from_jax(_randomize(shapes, np.random.default_rng(3)), cpu)
    return tp, unet_groups(SMOKE_UNET, tp)


def test_member_table_cached_per_shape_and_dtype(smoke):
    """A group list's table is built once per (shape, dtype) of its
    tensors; its gradients come back contiguous in each tensor's shape
    and dtype."""
    tp, groups = smoke
    tensors, tab = member_table(tp, groups)
    again, tab2 = member_table(tp, groups)
    assert tab2 is tab and all(a is b for a, b in zip(again, tensors))
    half, htab = member_table(tree_map(lambda v: v.bfloat16(), tp), groups)
    assert htab is not tab and htab.members == tab.members
    assert {dt for _, dt in htab.signature[0]} == {"bfloat16"}
    for ts, t in ((tensors, tab), (half, htab)):
        grads = gl2.segmented_sq_norms_backward_plain(
            ts, t, torch.ones(t.units))
        assert [(g.shape, g.dtype) for g in grads] == t.leaves
        assert all(g.is_contiguous() for g in grads)


def _records(tab):
    nm, ni, ng, _ = tab.counts
    d, m = tab.desc, gl2.MREC
    members = d[:m * nm].reshape(nm, m)
    items = d[m * nm:m * nm + 4 * ni].reshape(ni, 4)
    groups = d[m * nm + 4 * ni:m * nm + 4 * ni + 4 * ng].reshape(ng, 4)
    items2 = d[m * nm + 4 * ni + 4 * ng:].reshape(-1, 4)
    return members, items, groups, items2


def _item_elements(rec, c0, slab):
    """Flat element indices an item reads, as csrc indexes them:
    (rows, columns) in column mode, (rows, units, run) in run mode."""
    (_, _, run, _, outer, rowstride, start, R, size, _, _, _, _, _, rows,
     ncols) = rec[:16]                # ints 16-17: a client's offset, 0
    rr = np.arange(slab * rows, min(slab * rows + rows, outer))
    if not run:
        cols = np.arange(c0, min(c0 + gl2.TILE_COLS, ncols))
        return rr[:, None] * rowstride + start + cols[None, :], cols
    ks = np.arange(c0, min(c0 + gl2.TILE_UNITS, size))
    return (rr[:, None, None] * rowstride + start + ks[None, :, None] * R
            + np.arange(R)[None, None, :]), ks


def _emulate(tensors, tab, g):
    """The kernel's three passes in numpy from the descriptor."""
    members, items, groups, items2 = _records(tab)
    flat = [t.detach().float().reshape(-1).numpy() for t in tensors]
    reads = [np.zeros(f.size, np.int64) for f in flat]
    grads = [np.zeros(f.size, np.float32) for f in flat]
    partial = np.full(tab.partial_len, np.nan, np.float32)
    for mi, c0, slab, _ in items:
        rec = members[mi]
        t, run, R, base, pbase, pstride = rec[[0, 2, 7, 9, 10, 11]]
        idx, cols = _item_elements(rec, c0, slab)
        np.add.at(reads[t], idx.reshape(-1), 1)
        w = flat[t][idx]
        sq = (w.astype(np.float64) ** 2).sum(axis=(0, 2) if run else 0)
        partial[pbase + slab * pstride + cols] = sq
        unit = cols[None, :, None] if run else cols[None, :] // R
        grads[t][idx] = np.float32(2.0) * w * g[base + unit]
    out = np.full(tab.units, np.nan, np.float32)
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


def _owned_counts(tensors, tab):
    counts = [torch.zeros(t.shape, dtype=torch.int64) for t in tensors]
    for m, v in zip(tab.members, tab.views):
        counts[m.tensor].reshape(v).narrow(1, m.offset,
                                           m.size * m.chunk).add_(1)
    return [c.reshape(-1).numpy() for c in counts]


def _synthetic(r):
    """Layouts SMOKE lacks: several slabs and column tiles, a ragged run
    without 16-byte loads, chunked columns."""
    shapes = (((700, 300), "float32"), ((3, 37, 33), "float32"),
              ((27, 12), "float32"), ((5, 40), "bfloat16"))
    members = (gl2.Member(0, 1, 0, 1, 300, 0),
               gl2.Member(1, 1, 0, 1, 37, 300),
               gl2.Member(2, 1, 0, 3, 3, 337),
               gl2.Member(3, 1, 4, 12, 3, 337))
    tab = gl2.table((shapes, members))
    tensors = [torch.from_numpy(r.standard_normal(s).astype(np.float32)).to(
        getattr(torch, dt)) for s, dt in shapes]
    return tensors, tab


@pytest.mark.parametrize("case", ["smoke", "synthetic"])
def test_segmented_kernel_layout_emulated(case, smoke):
    r = np.random.default_rng(4)
    if case == "smoke":
        tensors, tab = member_table(*smoke)
    else:
        tensors, tab = _synthetic(r)
    g = r.standard_normal(tab.units).astype(np.float32)
    out, reads, grads = _emulate(tensors, tab, g)
    assert all(np.array_equal(a, b) for a, b in
               zip(reads, _owned_counts(tensors, tab)))
    want = gl2.segmented_sq_norms_plain(tensors, tab).numpy()
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    plain = gl2.segmented_sq_norms_backward_plain(tensors, tab,
                                                  torch.from_numpy(g))
    for got, p, c in zip(grads, plain, tab.covered):
        # bf16 tensors: the kernel rounds the fp32 product once, as here
        want = p.float().reshape(-1).numpy()
        got = torch.from_numpy(got).to(p.dtype).float().numpy()
        assert np.array_equal(got, want)
    if case == "synthetic":
        assert tab.covered == (True, True, False, False)
        with pytest.raises(ValueError, match="overlap"):
            gl2.table(((((4, 8), "float32"),),
                       (gl2.Member(0, 1, 0, 1, 5, 0),
                        gl2.Member(0, 1, 4, 1, 4, 5))))


@pytest.mark.parametrize("dtype,W,want", [
    (torch.float32, 4096, "tma"), (torch.bfloat16, 4096, "tma"),
    (torch.float32, 300, "tma"), (torch.bfloat16, 300, "simt"),
    (torch.float32, 4, "tma"), (torch.bfloat16, 4, "simt")])
def test_scan_variant(dtype, W, want):
    assert scan.variant(W, dtype) == want
