"""Streaming-softmax attention on (BH, S, hd).

Replaces the TPU kernel
``repro/kernels/flash_attention/flash_attention.py:flash_attention_bhsd``
with ``csrc/flash_attention.cu`` (the source says what bounds it on the
H100 and how the design answers that).  Any S and any hd up to 256 (144
after pruning) launch a kernel; the reference wrapper falls back to its
oracle when S is not a multiple of 128.  :func:`variant` picks one of
the source's two kernels: bf16 on ``wgmma`` fed by TMA, or the
register-tiled SIMT kernel (fp32, and bf16 rows TMA cannot address).

:func:`flash_attention_bhsd` dispatches on the tensor's device: a CUDA
tensor launches the kernel (counted in
``flash_attention_bhsd.launches``, and by shape in
``flash_attention_bhsd.shapes``), a CPU tensor runs
:func:`flash_attention_plain`.

:class:`FlashAttention` makes it differentiable with the reference's own
backward (``repro/models/ops.py:_attention_pallas_bwd``): a dense
recompute of the softmax from the saved q, k and v, with the same
masking and scale (:func:`attention_backward`).  The reference has no
backward kernel either.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
HD_MAX = 256
NEG_INF = -1e30
BQ = {"simt": 64, "wgmma": 128}     # query rows per block
KERNELS = {"simt": 0, "wgmma": 1}   # the C entry point's kernel argument


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel for a launch: ``"wgmma"`` for bf16 whose rows TMA can
    address (hd % 8 == 0: 16-byte row strides), else ``"simt"``."""
    if dtype == torch.bfloat16 and hd % 8 == 0:
        return "wgmma"
    return "simt"


def _scores(q, k, causal: bool, window: int) -> torch.Tensor:
    """fp32 scaled scores q k^T, masked entries at -1e30."""
    hd = q.shape[-1]
    Sq, Skv = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (hd ** -0.5)
    if causal or window > 0:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= (qpos - kpos) < window
        s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``ref.py``): dense
    softmax in fp32, masked scores at -1e30, output in q's dtype."""
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_backward(q, k, v, g, *, causal: bool, window: int):
    """(dq, dk, dv) of softmax attention, recomputed densely in fp32 from
    q, k and v: P = softmax(S), dV = P^T g, dP = g V^T,
    dS = P (dP - rowsum(P dP)), dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd).
    Masked scores have P = 0 and so no gradient."""
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(_scores(q, k, causal, window), dim=-1)
    gf = g.float()
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, v.float())
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float()) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """q (BH, Sq, hd); k, v (BH, Skv, hd) -> (BH, Sq, hd) in q's dtype."""
    if not q.is_cuda:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        raise ValueError(f"no kernel for device {q.device}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} are not (BH, S, hd)")
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    if not 1 <= hd <= HD_MAX:
        raise ValueError(f"head dim {hd} outside the kernel's 1..{HD_MAX}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         f"kernel takes float32 or bfloat16, one for all")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()) \
            or k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be contiguous and on one device")
    o = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return o
    if Skv == 0:
        raise ValueError("attention over zero keys")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, o))
    kern = variant(q.dtype, hd)
    if kern == "wgmma" and not aligned:
        raise ValueError("bf16 q, k and v must start 16-byte aligned: "
                         "their tiles arrive by TMA")
    if -(-Sq // BQ[kern]) > 65535:
        raise ValueError(f"Sq={Sq} exceeds the kernel grid's 65535 query "
                         f"tiles of {BQ[kern]}")
    lib = build.library()
    err = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), BH, Sq, Skv, hd, int(causal),
                                int(window), int(q.dtype == torch.bfloat16),
                                KERNELS[kern], int(aligned and hd % 4 == 0),
                                build.stream_handle(q.device))
    build.check(err, "flash_attention_bhsd")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.shapes[(BH, Sq, Skv, hd, bool(causal), int(window),
                                 str(q.dtype).removeprefix("torch."))] += 1
    return o


flash_attention_bhsd.launches = 0
# (BH, Sq, Skv, hd, causal, window, dtype) -> launches
flash_attention_bhsd.shapes = Counter()


class FlashAttention(torch.autograd.Function):
    """Differentiable :func:`flash_attention_bhsd`: the kernel forward,
    the dense recompute backward (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_bhsd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, g, causal=ctx.causal,
                                        window=ctx.window)
        return dq, dk, dv, None, None
