"""What the H100 kernels' designs decide in Python, checked on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py``); here:

- the masked matmul's launch plan (block tile and split-K) for the
  shapes the training and serving paths launch, and ragged ones;
- the bf16 attention kernel's rounding, emulated in plain PyTorch tile
  by tile as the kernel computes (fp32 scores from bf16 inputs, P
  rounded to bf16 for P V, l summed from the fp32 P), against the JAX
  kernel in interpret mode within the bf16 tolerance that
  ``chip_smoke.py`` holds the kernel to (1e-2 x max|ref|);
- which attention kernel a launch takes.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd
from repro_torch.kernels.block_masked_matmul import ops as bmm
from repro_torch.kernels.flash_attention import ops as fa


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
