"""Linear recurrence h_t = a_t * h_{t-1} + b_t over (B, S, W), h_{-1} = 0.

Replaces the TPU kernel ``repro/kernels/rglru_scan/rglru_scan.py:
rglru_scan`` with ``csrc/rglru_scan.cu`` (the source says what bounds it
on the H100 and how the design answers that).  The state is fp32 and
the output has ``a``'s dtype.  Any S launches the kernel; the
reference wrapper falls back to its oracle when its block length does
not divide S.  :func:`variant` picks one of the source's kernels: the
TMA-fed pipeline where TMA can address the rows (W * itemsize a multiple
of 16 bytes), else the SIMT kernel.

:func:`rglru_scan` dispatches on the tensor's device: a CUDA tensor
launches the kernel (counted in ``rglru_scan.launches``, and by shape in
``rglru_scan.shapes``), a CPU tensor runs :func:`rglru_scan_plain`.

The backward, :func:`rglru_scan_backward`, runs the recurrence in
reverse from the output gradient and the forward's output: the source's
backward kernels on a CUDA tensor (counted in
``rglru_scan.bwd_launches`` and ``rglru_scan.bwd_shapes``),
:func:`rglru_scan_backward_plain` on a CPU tensor.  :class:`RGLRUScan`
is the differentiable scan that ``models/rglru.py`` trains through; the
reference's gradient is that of its associative scan, which has no
kernel.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
KERNELS = {"simt": 0, "tma": 1}   # the C entry point's kernel argument


def variant(W: int, dtype: torch.dtype) -> str:
    """The kernel for a launch: ``"tma"`` where a row of W elements is a
    multiple of 16 bytes (TMA's stride rule), else ``"simt"``."""
    return "tma" if (W * dtype.itemsize) % 16 == 0 else "simt"


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``ref.py`` computes the
    same recurrence with an associative scan): a loop over t in fp32,
    each step a multiply and then an add, the state rounded to ``a``'s
    dtype only on output."""
    B, S, W = a.shape
    out = torch.empty_like(a)
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h.to(a.dtype)
    return out


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, W) -> h (B, S, W) in a's dtype."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"shapes a{tuple(a.shape)} b{tuple(b.shape)} are "
                         f"not one (B, S, W)")
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype}, {b.dtype}: the kernel takes "
                         f"float32 or bfloat16, one for both")
    if not (a.is_contiguous() and b.is_contiguous()) \
            or b.device != a.device:
        raise ValueError("a and b must be contiguous and on one device")
    B, S, W = a.shape
    h = launch(a, b, variant(W, a.dtype))
    rglru_scan.launches += 1
    rglru_scan.shapes[(B, S, W, str(a.dtype).removeprefix("torch."))] += 1
    return h


def rglru_scan_backward_plain(a: torch.Tensor, h: torch.Tensor,
                              g: torch.Tensor):
    """The backward's plain version: a reverse loop in fp32, delta_t =
    a_{t+1} * delta_{t+1} + g_t (a multiply and then an add, delta_S =
    0), db_t = delta_t and da_t = delta_t * h_{t-1} (h_{-1} = 0), each
    rounded to ``a``'s dtype on output.  Returns (da, db)."""
    B, S, W = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    zero = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    delta = zero
    for t in reversed(range(S)):
        a_next = a[:, t + 1].float() if t + 1 < S else zero
        delta = a_next * delta + g[:, t].float()
        db[:, t] = delta.to(a.dtype)
        da[:, t] = (delta * (h[:, t - 1].float() if t > 0 else zero)).to(
            a.dtype)
    return da, db


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """(da, db) of :func:`rglru_scan` for the output gradient ``g``,
    given a and the forward's output h, all (B, S, W) in one dtype."""
    if not (a.shape == h.shape == g.shape) or a.dim() != 3:
        raise ValueError(f"shapes a{tuple(a.shape)} h{tuple(h.shape)} "
                         f"g{tuple(g.shape)} are not one (B, S, W)")
    if a.device.type == "cpu":
        return rglru_scan_backward_plain(a, h, g)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype not in DTYPES or h.dtype != a.dtype or g.dtype != a.dtype:
        raise ValueError(f"dtypes {a.dtype}, {h.dtype}, {g.dtype}: the "
                         f"kernel takes float32 or bfloat16, one for all")
    if not all(t.is_contiguous() and t.device == a.device
               for t in (h, g)) or not a.is_contiguous():
        raise ValueError("a, h and g must be contiguous and on one device")
    B, S, W = a.shape
    da, db = launch_backward(a, h, g, variant(W, a.dtype))
    rglru_scan.bwd_launches += 1
    rglru_scan.bwd_shapes[(B, S, W, str(a.dtype).removeprefix("torch."))] \
        += 1
    return da, db


class RGLRUScan(torch.autograd.Function):
    """Differentiable :func:`rglru_scan`: the kernel forward, saving a
    and h, and :func:`rglru_scan_backward`."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return rglru_scan_backward(a, h, g.contiguous())


def launch(a: torch.Tensor, b: torch.Tensor, kernel: str) -> torch.Tensor:
    """Launch one of the source's kernels (:data:`KERNELS`) on checked
    CUDA tensors; :func:`rglru_scan` takes the one :func:`variant`
    picks."""
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel grid's 65535")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    if kernel != "simt" and not all(t.data_ptr() % 16 == 0
                                    for t in (a, b, h)):
        raise ValueError("a and b must start 16-byte aligned: their tiles "
                         "arrive by TMA")
    lib = build.library()
    err = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                B, S, W, int(a.dtype == torch.bfloat16),
                                KERNELS[kernel], build.stream_handle(a.device))
    build.check(err, "rglru_scan")
    return h


def launch_backward(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor,
                    kernel: str):
    """Launch one of the source's backward kernels (:data:`KERNELS`) on
    checked CUDA tensors; returns (da, db)."""
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"B={B} exceeds the kernel grid's 65535")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    if kernel != "simt" and not all(t.data_ptr() % 16 == 0
                                    for t in (g, a, h)):
        raise ValueError("g, a and h must start 16-byte aligned: their "
                         "tiles arrive by TMA")
    lib = build.library()
    err = lib.rglru_scan_bwd_launch(g.data_ptr(), a.data_ptr(), h.data_ptr(),
                                    da.data_ptr(), db.data_ptr(), B, S, W,
                                    int(a.dtype == torch.bfloat16),
                                    KERNELS[kernel],
                                    build.stream_handle(a.device))
    build.check(err, "rglru_scan_backward")
    return da, db


rglru_scan.launches = 0
rglru_scan.shapes = Counter()            # (B, S, W, dtype) -> launches
rglru_scan.bwd_launches = 0
rglru_scan.bwd_shapes = Counter()        # (B, S, W, dtype) -> launches
