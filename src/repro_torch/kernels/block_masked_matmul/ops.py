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
pruned tiles are skipped in the backward too (the kernel reads ``w.T``
in place from ``w``); dw is the masked fp32
``x.T @ g``, a plain product outside any kernel in the reference as well.
The launches that compute a dx are tallied apart, in
``block_masked_matmul.dx_shapes``.

A client axis batches C products of one shape into one launch (the
vectorized round engine's per-client GEMMs): x (C, M, K) and w (C, K, N)
(or (C, N, K) with ``trans_b``) give y (C, M, N), the masks shared by
every client.  Such a launch is tallied under ``(M, K, N, masked, dtype,
C)``; a 2-D launch keeps the key ``(M, K, N, masked, dtype)``.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
SMS = 132                    # the H100 SXM's streaming multiprocessors
BK = 8                       # the rows of K one thread group takes a step
# block tiles (bm, bn) -> thread groups splitting each k step in the
# block (the 64 x 64 tile's 4 groups give it 256 threads for shapes with
# few output tiles), threads, and blocks an SM holds at once (by
# registers: 128 a thread at 256 threads, 170 at 128)
KGROUPS = {(128, 128): 1, (128, 64): 1, (64, 128): 1, (64, 64): 4}
THREADS = {t: KGROUPS[t] * t[0] * t[1] // 64 for t in KGROUPS}
SLOTS = {t: 2 if THREADS[t] == 256 else 3 for t in KGROUPS}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)   # split-K candidates
# the plan's split-K cost model, fitted to every fp32 shape the training
# and serving paths launch, timed under each tile and split on an H100:
# an SM's FMAs per microsecond at full occupancy (the 64 x 64 tile's at
# RATE_64 of it: it reads twice the operand bytes per FMA and sums its K
# groups), the warps it needs for that, and a split's device cost (its partials written and read again,
# the summing kernel); on the host, a launch's own cost and what a split
# adds to it (the workspace's allocation, a second launch)
FMA_PER_US = 1.6e5
RATE_64 = 0.8
FULL_WARPS = 12
WS_BYTES_PER_US = 4e6
SPLIT_US = 4.0
HOST_US = 16.0
SPLIT_HOST_US = 12.0
GRID_Z = 65535               # the grid's z slices: clients x splits


class Plan(NamedTuple):
    """How one launch is cut: ``bm`` x ``bn`` output blocks, K cut into
    ``splits`` slices of ``per`` k steps of :meth:`depth` rows (the last
    may be shorter, none is empty)."""
    bm: int
    bn: int
    splits: int
    per: int

    def depth(self) -> int:
        return BK * KGROUPS[self.bm, self.bn]

    def blocks(self, M: int, N: int, C: int = 1) -> int:
        return -(-M // self.bm) * -(-N // self.bn) * self.splits * C


def _cost_us(p: Plan, M: int, N: int, C: int) -> float:
    """Modelled time: the busiest SM's FMAs over its rate, the rate cut
    when the SM holds fewer than FULL_WARPS warps, plus a split's device
    cost; never less than the launch's host cost."""
    per_sm = -(-p.blocks(M, N, C) // SMS)
    warps = min(per_sm, SLOTS[p.bm, p.bn]) * THREADS[p.bm, p.bn] // 32
    rate = FMA_PER_US * (RATE_64 if p.bm == p.bn == 64 else 1.0)
    t = per_sm * p.per * p.bm * p.bn * p.depth() \
        / (rate * min(1.0, warps / FULL_WARPS))
    host = HOST_US
    if p.splits > 1:
        t += SPLIT_US + 8.0 * p.splits * C * M * N / WS_BYTES_PER_US
        host += SPLIT_HOST_US
    return max(t, host)


def _edge(n: int) -> int:
    """64 where 64-wide tiles pad n less than 128-wide ones, else 128."""
    return 64 if -(-n // 64) * 64 < -(-n // 128) * 128 else 128


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, C: int = 1) -> Plan:
    """The kernel variant for C (M, K) @ (K, N) products in one launch.

    Two candidate tiles: each block edge 64 where that pads M (or N)
    less than 128, else 128 (N's edge drops to 64 when 128-wide tiles
    could not give every SM a block even one k step a slice), and the
    64 x 64 tile with its four K groups.  For each, the split-K ladder;
    the least modelled time (:func:`_cost_us`) wins.  A tile whose
    output blocks, over all C clients, already fill every SM's slots is
    not split, and C x splits stays within the grid's 65535 z slices.
    """
    bm, bn = _edge(M), _edge(N)
    if bn == 128 and C * -(-M // bm) * -(-N // bn) \
            * min(-(-K // BK), SPLITS[-1]) < SMS:
        bn = 64
    best = None
    for tile in dict.fromkeys(((bm, bn), (64, 64))):
        steps = max(1, -(-K // (BK * KGROUPS[tile])))
        tiles = C * -(-M // tile[0]) * -(-N // tile[1])
        for s in SPLITS if tiles < SMS * SLOTS[tile] else (1,):
            if s > steps or C * s > GRID_Z:
                break
            per = -(-steps // s)
            p = Plan(*tile, -(-steps // per), per)
            c = _cost_us(p, M, N, C)
            if best is None or c < best[0]:
                best = (c, p)
    return best[1]


def block_masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                              col_mask: Optional[torch.Tensor] = None,
                              row_mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``ref.py``): fp32
    accumulation, output in x's dtype; x (C, M, K) and w (C, K, N) are
    C products."""
    wm = w
    if col_mask is not None:
        wm = wm * col_mask[None, :].to(w.dtype)
    if row_mask is not None:
        wm = wm * row_mask[:, None].to(w.dtype)
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def _check_mask(m, n, device, name):
    if m.shape != (n,) or m.dtype != torch.float32 or m.device != device \
            or not m.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor "
                         f"on {device}; got {tuple(m.shape)} {m.dtype} on "
                         f"{m.device}")


def block_masked_matmul(x: torch.Tensor, w: torch.Tensor,
                        col_mask: Optional[torch.Tensor] = None,
                        row_mask: Optional[torch.Tensor] = None, *,
                        role: str = "fwd", trans_b: bool = False
                        ) -> torch.Tensor:
    """x (M, K) @ masked w (K, N) -> (M, N) in x's dtype, or C such
    products at once: x (C, M, K) @ w (C, K, N) -> (C, M, N).

    Masks are float32 vectors (``None`` = all ones), shared by every
    client.  With ``trans_b`` the kernel reads B = ``w.T`` in place from
    a row-major ``w`` (N, K) (or (C, N, K)).  On a CUDA tensor this
    launches the hand-written kernel or raises; on a CPU tensor it runs
    the plain version.  ``role="dx"`` marks a backward launch, which is
    tallied in ``dx_shapes`` as well.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return block_masked_matmul_plain(
                x, w.transpose(-1, -2) if trans_b else w, col_mask, row_mask)
        raise ValueError(f"no kernel for device {x.device}")
    batched = x.dim() == 3
    if x.dim() not in (2, 3) or w.dim() != x.dim() \
            or x.shape[-1] != w.shape[-1 if trans_b else -2] \
            or (batched and x.shape[0] != w.shape[0]):
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not "
                         f"form a matmul")
    dtype = DTYPES.get(x.dtype)
    if dtype is None or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {w.dtype}: the kernel takes "
                         f"float32 or bfloat16, the same for x and w")
    dev = x.device
    if w.device != dev or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous and on one device")
    C = x.shape[0] if batched else 1
    M, K = x.shape[-2:]
    N = w.shape[-2] if trans_b else w.shape[-1]
    if col_mask is not None:
        _check_mask(col_mask, N, dev, "col_mask")
    if row_mask is not None:
        _check_mask(row_mask, K, dev, "row_mask")
    y = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=dev)
    if M == 0 or N == 0 or C == 0:
        return y
    if N > 65535 * 64:
        raise ValueError(f"N={N} exceeds the kernel grid's 65535 tiles")
    if C > GRID_Z or C * max(M, K, N) >= 2 ** 31:
        raise ValueError(f"{C} clients of {M} x {K} x {N}: the grid takes "
                         f"{GRID_Z} and the kernel's rows 2^31")
    p = plan(M, K, N, C)
    ws = None if p.splits == 1 else \
        torch.empty((C, p.splits, M, N), dtype=torch.float32, device=dev)
    wp = w.data_ptr()
    # 16-byte copies of w's rows (not when read transposed); every
    # client's rows start K * N elements apart, so N % 4 keeps them aligned
    vec = not trans_b and N % 4 == 0 and wp % 16 == 0
    err = build.library().bmm_launch(
        x.data_ptr(), wp, None if col_mask is None else col_mask.data_ptr(),
        None if row_mask is None else row_mask.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), C, M, K, N,
        int(dtype == "bfloat16"), int(trans_b), p.bm, p.bn, p.splits, p.per,
        int(vec), build.stream_handle(dev))
    build.check(err, "block_masked_matmul")
    key = (M, K, N, col_mask is not None or row_mask is not None, dtype)
    if batched:
        key += (C,)
    block_masked_matmul.launches += 1
    block_masked_matmul.shapes[key] += 1
    if role == "dx":
        block_masked_matmul.dx_shapes[key] += 1
    return y


block_masked_matmul.launches = 0
block_masked_matmul.shapes = Counter()   # (M, K, N, masked, dtype) -> launches
block_masked_matmul.dx_shapes = Counter()   # the same, backward dx only


class MaskedMatmul(torch.autograd.Function):
    """Differentiable :func:`block_masked_matmul` (module docstring), 2-D
    or with a client axis.  Masks get no gradient."""

    @staticmethod
    def forward(ctx, x, w, col_mask, row_mask):
        ctx.save_for_backward(x, w, col_mask, row_mask)
        return block_masked_matmul(x, w, col_mask, row_mask)

    @staticmethod
    def backward(ctx, g):
        x, w, col_mask, row_mask = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # B = w.T, read in place from w
            dx = block_masked_matmul(g.to(w.dtype).contiguous(), w,
                                     row_mask, col_mask, role="dx",
                                     trans_b=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.transpose(-1, -2).float(), g.float())
            if row_mask is not None:
                dw = dw * row_mask[:, None]
            if col_mask is not None:
                dw = dw * col_mask[None, :]
            dw = dw.to(w.dtype)
        return dx, dw, None, None
