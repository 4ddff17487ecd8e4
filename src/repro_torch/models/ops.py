"""The U-Net's tensor-core ops (``repro/models/ops.py``), on the port's
kernels.

Every GEMM (im2col convs, 1x1 convs, denses) goes through
:func:`masked_matmul` and so through the block-masked matmul kernel;
attention goes through the flash-attention kernel; the pruning
reductions through the group sum-of-squares kernel.  Each goes through
its wrapper's ``torch.autograd.Function``, so the training loss
differentiates through the same kernels (the matmul's dx launches the
matmul kernel again).  Which version runs
is decided by the tensors' device alone (see :mod:`repro_torch.kernels`):
there is no backend option.

Stacked weights: the vectorized round engine trains C clients at once
on parameters with a leading (C,) axis (a (C, K, N) dense weight, a
(C, kh, kw, cin, cout) conv weight, a (C, N) bias) and activations whose
batch axis holds the clients one after another, (C * B, ...).  A
stacked weight sends its GEMM to the matmul kernel's client axis: one
launch for all C clients, as the reference's ``vmap`` batches its
Pallas call.  Such weights take device masks only, shared by every
client.

Masks come in two types, as in the reference:

- a ``torch.Tensor`` mask is a training-style device mask: the kernel
  multiplies the pruned rows/columns by zero and skips fully masked
  tiles;
- a host ``np.ndarray`` mask is a serving constant: the kept rows and
  columns are gathered, a smaller GEMM runs and its output is scattered
  back.  The gather is always element-granular, because the port's
  kernel takes any shape (the reference falls back to 128-block
  granularity to keep its TPU kernel's tile alignment).  The result
  equals the device-mask route up to reduction order: the dropped terms
  are exact zeros.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.experiment.resolve import resolve_precision
from repro_torch.kernels.block_masked_matmul import ops as bmm
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.group_l2_norms import ops as gl2
from repro_torch.tree import tree_map

Mask = Union[None, np.ndarray, torch.Tensor]

_COMPUTE_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def compute_dtype(precision: str) -> torch.dtype:
    """The torch dtype a resolved precision computes in."""
    return _COMPUTE_DTYPE[resolve_precision(precision)]


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested dict/list to ``dtype``;
    other leaves pass through."""
    return tree_map(lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t, tree)


def _gemm_cast(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Activations follow reduced-precision weights into the GEMM, so
    both inputs share one dtype; full-precision weights leave x alone."""
    if w.dtype in _LOW_PRECISION and x.dtype != w.dtype:
        return x.to(w.dtype)
    return x


def is_static_mask(m) -> bool:
    """Host (numpy) masks select the gather -> GEMM -> scatter route."""
    return isinstance(m, np.ndarray)


def _static_masks(col_mask: Mask, row_mask: Mask) -> bool:
    if col_mask is None and row_mask is None:
        return False
    return (col_mask is None or is_static_mask(col_mask)) and \
        (row_mask is None or is_static_mask(row_mask))


def _device_mask(m: Mask, device) -> Optional[torch.Tensor]:
    if m is None:
        return None
    return torch.as_tensor(m, dtype=torch.float32, device=device).contiguous()


# ---------------------------------------------------------------------------
# masked matmul
# ---------------------------------------------------------------------------

def _masked_matmul_static(x2: torch.Tensor, w: torch.Tensor,
                          col_mask: Mask, row_mask: Mask) -> torch.Tensor:
    """Gather the kept rows/columns, run the smaller GEMM on the kernel,
    scatter the kept columns back into zeros."""
    K, N = w.shape
    ridx = np.arange(K) if row_mask is None \
        else np.nonzero(np.asarray(row_mask))[0]
    cidx = np.arange(N) if col_mask is None \
        else np.nonzero(np.asarray(col_mask))[0]
    if ridx.size == 0 or cidx.size == 0:
        return torch.zeros((x2.shape[0], N), dtype=x2.dtype,
                           device=x2.device)
    dev = x2.device
    xr, wr = x2, w
    if ridx.size != K:
        ri = torch.from_numpy(ridx).to(dev)
        xr = x2.index_select(1, ri)
        wr = wr.index_select(0, ri)
    if cidx.size != N:
        wr = wr.index_select(1, torch.from_numpy(cidx).to(dev))
    # the kept entries of a 0/1 mask are all ones: no mask on the kernel
    out_r = bmm.MaskedMatmul.apply(xr.contiguous(), wr.contiguous(), None,
                                   None)
    if cidx.size == N:
        return out_r
    out = torch.zeros((x2.shape[0], N), dtype=out_r.dtype, device=dev)
    out[:, torch.from_numpy(cidx).to(dev)] = out_r
    return out


def masked_matmul(x: torch.Tensor, w: torch.Tensor, col_mask: Mask = None,
                  row_mask: Mask = None) -> torch.Tensor:
    """``x @ (w * col_mask[None] * row_mask[:, None])``; x (..., K),
    w (K, N), masks 0/1 vectors (``None`` = all ones).  Host numpy masks
    take the gather route (module docstring).  A stacked w (C, K, N)
    multiplies each client's rows of x (its leading axis holds the C
    clients one after another) by that client's weight, in one launch."""
    x = _gemm_cast(x, w)
    lead = x.shape[:-1]
    if w.dim() == 3:
        if _static_masks(col_mask, row_mask):
            raise ValueError("stacked weights take device masks, not host "
                             "numpy ones")
        x3 = x.reshape(w.shape[0], -1, x.shape[-1]).contiguous()
        out = bmm.MaskedMatmul.apply(x3, w.contiguous(),
                                     _device_mask(col_mask, x.device),
                                     _device_mask(row_mask, x.device))
        return out.reshape(lead + (w.shape[-1],))
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if _static_masks(col_mask, row_mask):
        out = _masked_matmul_static(x2, w, col_mask, row_mask)
    else:
        out = bmm.MaskedMatmul.apply(x2, w.contiguous(),
                                     _device_mask(col_mask, x.device),
                                     _device_mask(row_mask, x.device))
    return out.reshape(lead + (w.shape[1],))


# ---------------------------------------------------------------------------
# dense / conv (im2col -> matmul)
# ---------------------------------------------------------------------------

def _masked_bias(b: torch.Tensor, col_mask: Mask) -> torch.Tensor:
    if col_mask is None:
        return b
    return b * torch.as_tensor(col_mask, device=b.device).to(b.dtype)


def _add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y + b`` over y's last axis; a stacked bias (C, N) adds client
    c's row to client c's share of y's leading axis."""
    if b.dim() == 1:
        return y + b
    C = b.shape[0]
    return (y.reshape((C, -1) + y.shape[1:])
            + b.reshape((C,) + (1,) * (y.dim() - 1) + b.shape[-1:])
            ).reshape(y.shape)


def dense(p, x: torch.Tensor, *, col_mask: Mask = None) -> torch.Tensor:
    """``x @ p["w"] + p["b"]``; ``col_mask`` prunes output features
    (weight columns and bias).  Stacked p: x (C * B, K)."""
    return _add_bias(masked_matmul(x, p["w"], col_mask, None),
                     _masked_bias(p["b"], col_mask))


def same_pads(size: int, k: int, stride: int):
    """Output size and (before, after) padding of a SAME conv: a stride-2
    3x3 conv on an even size pads (0, 1), not (1, 1)."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return out, (pad // 2, pad - pad // 2)


def conv(p, x: torch.Tensor, *, stride: int = 1, col_mask: Mask = None,
         row_mask: Mask = None) -> torch.Tensor:
    """SAME conv on NHWC x with (kh, kw, cin, cout) weights, lowered as
    im2col + GEMM.  ``col_mask`` (cout,) prunes output channels (weight
    columns and bias); ``row_mask`` (cin,) prunes input channels, tiled
    over the kh*kw patch positions of the im2col K axis.  A stacked
    weight (C, kh, kw, cin, cout) convolves client c's share of x's batch
    axis with its own weight (one matmul launch for all C)."""
    w = p["w"]
    lead, (kh, kw, cin, cout) = w.shape[:-4], w.shape[-4:]
    bias = _masked_bias(p["b"], col_mask)
    x = _gemm_cast(x, w)
    if kh == kw == 1 and stride == 1:
        out = masked_matmul(x.reshape(-1, cin), w[..., 0, 0, :, :], col_mask,
                            row_mask)
        return _add_bias(out.reshape(x.shape[:-1] + (cout,)), bias)
    B, H, W = x.shape[:3]
    oh, (ph0, ph1) = same_pads(H, kh, stride)
    ow, (pw0, pw1) = same_pads(W, kw, stride)
    xp = torch.nn.functional.pad(x, (0, 0, pw0, pw1, ph0, ph1))
    cols = [xp[:, di:di + stride * (oh - 1) + 1:stride,
               dj:dj + stride * (ow - 1) + 1:stride, :]
            for di in range(kh) for dj in range(kw)]
    patches = torch.stack(cols, dim=3)           # (B, oh, ow, kh*kw, cin)
    rm = None
    if row_mask is not None:                     # im2col K = patch*cin + c
        rm = np.tile(row_mask, kh * kw) if is_static_mask(row_mask) \
            else row_mask.repeat(kh * kw)
    y = masked_matmul(patches.reshape(-1, kh * kw * cin),
                      w.reshape(lead + (kh * kw * cin, cout)), col_mask, rm)
    return _add_bias(y.reshape(B, oh, ow, cout), bias)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, Hkv, hd) -> (B, Sq, H, hd).  GQA
    groups are expanded; the U-Net calls this with H = 1."""
    B, Sq, H, hd = q.shape
    if k.shape[2] != H:
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * H, -1, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * H, -1, hd).contiguous()
    out = flash.FlashAttention.apply(qf, kf, vf, causal, window)
    return out.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# group sum-of-squares reductions (Eq. 17)
# ---------------------------------------------------------------------------

def group_sq_norms_2d(w2d: torch.Tensor, num_groups: int) -> torch.Tensor:
    """(K, G*C) -> (G,) fp32 per-group sums of squares over contiguous
    column chunks."""
    w = w2d.float().contiguous()
    return segmented_sq_norms(
        [w], gl2.single_table(w.shape, "float32", num_groups))


def segmented_sq_norms(tensors, table) -> torch.Tensor:
    """(units,) fp32 per-unit sums of squares of ``table``'s members of
    ``tensors`` (:mod:`repro_torch.kernels.group_l2_norms.ops`), one
    launch forward and one backward."""
    return gl2.SegmentedSqNorms.apply(table, *tensors)
