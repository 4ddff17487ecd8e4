"""Per-group sums of squares: (K, G*C) -> (G,) fp32 over contiguous
column chunks (the pruning criterion's inner reduction, Eq. 17).

Replaces the TPU kernel
``repro/kernels/group_l2_norms/group_l2_norms.py:group_l2_norms`` with
``csrc/group_l2_norms.cu`` (the source says what bounds it on the H100
and how the design answers that).  The reduction is deterministic: no
atomics, so repeated runs give identical scores.

:func:`group_l2_norms` dispatches on the tensor's device: a CUDA tensor
launches the kernel (counted in ``group_l2_norms.launches``, and by
shape in ``group_l2_norms.shapes``), a CPU tensor runs
:func:`group_l2_norms_plain`.

:class:`GroupSqNorms` makes it differentiable for the Omega
regularizer, with the reference's analytic backward
``2 * w * repeat(g, chunk)`` (``repro/models/ops.py:_group_sq_pallas_bwd``)
in plain tensor ops.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build

ROWS_PER_SLAB = 128          # the kernel's first-pass row slab


def group_l2_norms_plain(w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``ref.py``)."""
    K, N = w.shape
    wr = w.float().reshape(K, num_groups, N // num_groups)
    return torch.sum(wr * wr, dim=(0, 2))


def group_l2_norms(w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """w (K, G*C) float32 -> (G,) float32."""
    if w.dim() != 2 or num_groups < 1 or w.shape[1] % num_groups:
        raise ValueError(f"{tuple(w.shape)} does not split into "
                         f"{num_groups} column groups")
    if w.device.type == "cpu":
        return group_l2_norms_plain(w, num_groups)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"the kernel takes a contiguous float32 tensor; got "
                         f"{w.dtype}, contiguous={w.is_contiguous()}")
    K, N = w.shape
    out = torch.empty((num_groups,), dtype=torch.float32, device=w.device)
    if K == 0:
        return out.zero_()
    slabs = -(-K // ROWS_PER_SLAB)
    partial = torch.empty((slabs, N), dtype=torch.float32, device=w.device)
    lib = build.library()
    err = lib.group_l2_launch(w.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), K, N, num_groups,
                              build.stream_handle(w.device))
    build.check(err, "group_l2_norms")
    group_l2_norms.launches += 1
    group_l2_norms.shapes[(K, N, num_groups)] += 1
    return out


group_l2_norms.launches = 0
group_l2_norms.shapes = Counter()        # (K, N, G) -> launches


class GroupSqNorms(torch.autograd.Function):
    """Differentiable :func:`group_l2_norms` (module docstring)."""

    @staticmethod
    def forward(ctx, w, num_groups: int):
        ctx.save_for_backward(w)
        ctx.num_groups = num_groups
        return group_l2_norms(w, num_groups)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        chunk = w.shape[1] // ctx.num_groups
        return 2.0 * w * g.repeat_interleave(chunk)[None, :], None
