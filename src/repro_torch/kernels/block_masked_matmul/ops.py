"""Block-masked matmul: ``y = x @ (w * col_mask[None] * row_mask[:, None])``.

Replaces the TPU kernel
``repro/kernels/block_masked_matmul/block_masked_matmul.py:block_masked_matmul``
with ``csrc/block_masked_matmul.cu`` (the source says what bounds it on
the H100 and how the design answers that).  Unlike the reference
wrapper, which falls back to its oracle off 128-alignment, the CUDA
kernel takes any M, K and N.

:func:`block_masked_matmul` dispatches on the tensor's device: a CUDA
tensor launches the kernel (and counts the launch in
``block_masked_matmul.launches``, and by shape in
``block_masked_matmul.shapes``), a CPU tensor runs
:func:`block_masked_matmul_plain`.

:class:`MaskedMatmul` makes it differentiable, as the reference's
``custom_vjp`` does (``repro/models/ops.py:_masked_matmul_pallas_bwd``):
dx is the same kernel on ``g`` and ``w.T`` with the masks swapped, so
pruned tiles are skipped in the backward too; dw is the masked fp32
``x.T @ g``, a plain product outside any kernel in the reference as well.
The launches that compute a dx are tallied apart, in
``block_masked_matmul.dx_shapes``.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
MAX_M = 65535 * 64           # the grid's y extent times the 64-row tile


def block_masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                              col_mask: Optional[torch.Tensor] = None,
                              row_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``ref.py``): fp32
    accumulation, output in x's dtype."""
    wm = w
    if col_mask is not None:
        wm = wm * col_mask[None, :].to(w.dtype)
    if row_mask is not None:
        wm = wm * row_mask[:, None].to(w.dtype)
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def _check_mask(m, n, device, name):
    if m is None:
        return None
    if m.shape != (n,) or m.dtype != torch.float32 or m.device != device \
            or not m.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor "
                         f"on {device}; got {tuple(m.shape)} {m.dtype} on "
                         f"{m.device}")
    return m


def block_masked_matmul(x: torch.Tensor, w: torch.Tensor,
                        col_mask: Optional[torch.Tensor] = None,
                        row_mask: Optional[torch.Tensor] = None, *,
                        role: str = "fwd") -> torch.Tensor:
    """x (M, K) @ masked w (K, N) -> (M, N) in x's dtype.

    Masks are float32 vectors (``None`` = all ones).  On a CUDA tensor
    this launches the hand-written kernel or raises; on a CPU tensor it
    runs the plain version.  ``role="dx"`` marks a backward launch, which
    is tallied in ``dx_shapes`` as well.
    """
    if x.device.type == "cpu":
        return block_masked_matmul_plain(x, w, col_mask, row_mask)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not "
                         f"form a matmul")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: the kernel takes "
                         f"float32 or bfloat16, the same for x and w")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous and on one device")
    M, K = x.shape
    N = w.shape[1]
    if M > MAX_M:
        raise ValueError(f"M={M} exceeds the kernel's {MAX_M} rows")
    cm = _check_mask(col_mask, N, x.device, "col_mask")
    rm = _check_mask(row_mask, K, x.device, "row_mask")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    lib = build.library()
    err = lib.bmm_launch(x.data_ptr(), w.data_ptr(),
                         None if cm is None else cm.data_ptr(),
                         None if rm is None else rm.data_ptr(),
                         y.data_ptr(), M, K, N,
                         int(x.dtype == torch.bfloat16),
                         build.stream_handle(x.device))
    build.check(err, "block_masked_matmul")
    key = (M, K, N, cm is not None or rm is not None,
           str(x.dtype).removeprefix("torch."))
    block_masked_matmul.launches += 1
    block_masked_matmul.shapes[key] += 1
    if role == "dx":
        block_masked_matmul.dx_shapes[key] += 1
    return y


block_masked_matmul.launches = 0
block_masked_matmul.shapes = Counter()   # (M, K, N, masked, dtype) -> launches
block_masked_matmul.dx_shapes = Counter()   # the same, backward dx only


class MaskedMatmul(torch.autograd.Function):
    """Differentiable :func:`block_masked_matmul` (module docstring).
    Masks get no gradient."""

    @staticmethod
    def forward(ctx, x, w, col_mask, row_mask):
        ctx.save_for_backward(x, w, col_mask, row_mask)
        return block_masked_matmul(x, w, col_mask, row_mask)

    @staticmethod
    def backward(ctx, g):
        x, w, col_mask, row_mask = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # a contiguous copy of w.T; the kernel reads B row-major
            dx = block_masked_matmul(g.to(w.dtype).contiguous(),
                                     w.t().contiguous(), row_mask, col_mask,
                                     role="dx").to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.t().float(), g.float())
            if row_mask is not None:
                dw = dw * row_mask[:, None]
            if col_mask is not None:
                dw = dw * col_mask[None, :]
            dw = dw.to(w.dtype)
        return dx, dw, None, None
