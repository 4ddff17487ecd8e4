"""Segmented per-unit sums of squares (the pruning criterion's inner
reduction, Eq. 17) over many parameter slices in one launch, and their
gradient.

Replaces the TPU kernel
``repro/kernels/group_l2_norms/group_l2_norms.py:group_l2_norms``, a
(K, G*C) -> (G,) reduction over contiguous column chunks, with
``csrc/group_l2_norms.cu`` (the source says what bounds it on the H100
and how the design answers that).  The reduction is deterministic: no
atomics, so repeated runs give identical scores.

A :class:`Table` describes one launch: the shapes and dtypes of its
tensors and its :class:`Member` slices.  Member ``m`` sees tensor
``m.tensor`` as (outer, L, inner) around ``m.axis``; its unit ``k`` owns
the indices ``[offset + k*chunk, offset + (k+1)*chunk)`` along the axis,
and its sum lands in unit ``base + k`` of one flat ``(units,)`` fp32
output.  Consecutive members with one ``base`` and ``size`` form a group
whose units are summed over those members, in member order.
:func:`table` builds the layout (work items, partials, the device
descriptor) once per signature.

:func:`segmented_sq_norms` dispatches on the tensors' device: CUDA
tensors launch the kernel, CPU tensors run
:func:`segmented_sq_norms_plain`, which walks the members one by one
with the single-matrix reduction :func:`group_l2_norms_plain`.
:class:`SegmentedSqNorms` makes it differentiable: its backward is the
reference's ``2 * w * g[unit]`` (``repro/models/ops.py:
_group_sq_pallas_bwd``) for every member at once, one kernel launch on
the card (:func:`segmented_sq_norms_backward`).
:func:`group_l2_norms` is the single-matrix form, a one-member launch.

Every forward launch counts in ``group_l2_norms.launches`` and, by
signature, in ``group_l2_norms.shapes``; backward launches in
``group_l2_norms.bwd_launches`` and ``.bwd_shapes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from collections import Counter
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

MAX_TENSORS = 240            # the kernel's by-value pointer table (csrc)
THREADS = 256
TILE_COLS = 256              # column mode: columns a block covers
TILE_UNITS = THREADS // 32   # run mode: units a block covers, one a warp
RUN_MIN = 32                 # run mode where a unit owns >= 32 elements a row
ITEM_BYTES = 32768           # reads per work item, about
DTYPES = (torch.float32, torch.bfloat16)


class Member(NamedTuple):
    """One parameter slice of a launch (module docstring)."""
    tensor: int
    axis: int
    offset: int
    chunk: int
    size: int
    base: int


# ((shape, dtype name) per tensor, members): the key of a layout
Signature = Tuple[Tuple[Tuple[Tuple[int, ...], str], ...], Tuple[Member, ...]]


@dataclasses.dataclass(eq=False)
class Table:
    """One launch's layout, built by :func:`table`."""
    signature: Signature
    leaves: List[tuple]           # (shape, torch dtype) per tensor
    units: int
    views: Tuple[Tuple[int, int, int], ...]   # (outer, L, inner) per member
    groups: Tuple[Tuple[int, int, int, int], ...]   # (base, size, m0, m1)
    covered: Tuple[bool, ...]     # per tensor: do its members own all of it
    desc: np.ndarray              # int32 [members | items | groups | items2]
    counts: Tuple[int, int, int, int]   # members, items, groups, items2
    partial_len: int
    _on_device: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @property
    def members(self) -> Tuple[Member, ...]:
        return self.signature[1]

    def member_bytes(self) -> int:
        """Bytes of every member element, each read once."""
        return sum(math.prod(self.signature[0][m.tensor][0])
                   // v[1] * m.size * m.chunk
                   * getattr(torch, self.signature[0][m.tensor][1]).itemsize
                   for m, v in zip(self.members, self.views))

    def on(self, device: torch.device) -> torch.Tensor:
        """The descriptor on ``device``, copied there once."""
        if device not in self._on_device:
            self._on_device[device] = torch.from_numpy(self.desc).to(device)
        return self._on_device[device]


def _view(shape, axis):
    return (math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:]))


@functools.lru_cache(maxsize=32)
def table(signature: Signature) -> Table:
    """Validate ``signature`` and lay out its launch: a member record
    per member (the order ``csrc``'s ``Member`` reads), a work item per
    (member, row slab, column or unit tile) of about ITEM_BYTES, a group
    record per run of members with one base, and a pass-2 item per 256
    units of a group."""
    tensors, members = signature
    if not members:
        raise ValueError("a launch needs at least one member")
    mrec, items, views, owned = [], [], [], {}
    groups, items2 = [], []
    units = plen = 0
    for i, m in enumerate(members):
        if not 0 <= m.tensor < len(tensors):
            raise ValueError(f"member {i} names tensor {m.tensor} of "
                             f"{len(tensors)}")
        shape, dt = tensors[m.tensor]
        if not 0 <= m.axis < len(shape) or m.chunk < 1 or m.size < 1 \
                or m.offset < 0 \
                or m.offset + m.size * m.chunk > shape[m.axis]:
            raise ValueError(f"member {i} {m} does not fit shape {shape}")
        if math.prod(shape) >= 2 ** 31:
            raise ValueError(f"tensor {m.tensor} {shape}: 2^31 elements or "
                             f"more")
        if not groups or m.base != groups[-1][0]:
            if m.base != units:
                raise ValueError(f"member {i}: base {m.base}, want {units} "
                                 f"(groups follow one another)")
            groups.append([m.base, m.size, i, i + 1])
            units += m.size
        elif m.size != groups[-1][1]:
            raise ValueError(f"member {i}: size {m.size} in a group of "
                             f"{groups[-1][1]}")
        else:
            groups[-1][3] = i + 1
        owned.setdefault(m.tensor, []).append(
            (m.axis, m.offset, m.offset + m.size * m.chunk))
        outer, L, inner = _view(shape, m.axis)
        views.append((outer, L, inner))
        R = m.chunk * inner
        ncols = m.size * R
        itemsize = getattr(torch, dt).itemsize
        run = R >= RUN_MIN
        if run:
            row_bytes = TILE_UNITS * R * itemsize
            tiles = range(0, m.size, TILE_UNITS)
            pstride, pr = m.size, 1
            vec = R % 4 == 0
        else:
            row_bytes = min(ncols, TILE_COLS) * itemsize
            tiles = range(0, ncols, TILE_COLS)
            pstride, pr = ncols, R
            vec = ncols % 4 == 0
        vec = vec and (L * inner) % 4 == 0 and (m.offset * inner) % 4 == 0
        rows = max(1, ITEM_BYTES // row_bytes)
        nslabs = -(-outer // rows)
        mrec.append([m.tensor, int(dt == "bfloat16"), int(run), int(vec),
                     outer, L * inner, m.offset * inner, R, m.size, m.base,
                     plen, pstride, pr, nslabs, rows, ncols])
        items += [[i, t, s, 0] for s in range(nslabs) for t in tiles]
        plen += nslabs * pstride
    covered = []
    for t in range(len(tensors)):
        spans = sorted(owned.get(t, ()), key=lambda s: s[1])
        if len({a for a, _, _ in spans}) > 1 or any(
                a[2] > b[1] for a, b in zip(spans, spans[1:])):
            raise ValueError(f"tensor {t}: its members overlap or use two "
                             f"axes")
        covered.append(bool(spans) and sum(e - s for _, s, e in spans)
                       == tensors[t][0][spans[0][0]])
    for g, (base, size, _, _) in enumerate(groups):
        items2 += [[g, u, 0, 0] for u in range(0, size, THREADS)]
    desc = np.asarray(list(itertools.chain.from_iterable(
        mrec + items + groups + items2)), np.int32)
    leaves = [(shape, getattr(torch, dt)) for shape, dt in tensors]
    return Table(signature=signature, leaves=leaves, units=units,
                 views=tuple(views),
                 groups=tuple(map(tuple, groups)), covered=tuple(covered),
                 desc=desc, counts=(len(mrec), len(items), len(groups),
                                    len(items2)), partial_len=plen)


def single_table(shape, dtype: str, num_groups: int) -> Table:
    """The one-member table of a (K, G*C) matrix with G column groups."""
    if len(shape) != 2 or num_groups < 1 or shape[1] % num_groups:
        raise ValueError(f"{tuple(shape)} does not split into "
                         f"{num_groups} column groups")
    K, N = shape
    return table(((((int(K), int(N)), dtype),),
                  (Member(0, 1, 0, N // num_groups, num_groups, 0),)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def group_l2_norms_plain(w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """The plain PyTorch version (the reference's ``ref.py``)."""
    K, N = w.shape
    wr = w.float().reshape(K, num_groups, N // num_groups)
    return torch.sum(wr * wr, dim=(0, 2))


def owned_2d(t: torch.Tensor, m: Member, view) -> torch.Tensor:
    """Member ``m``'s slice of ``t``, its axis moved last, as (K,
    size*chunk): the single-matrix kernel's layout."""
    outer, L, inner = view
    sl = t.reshape(outer, L, inner).narrow(1, m.offset, m.size * m.chunk)
    return sl.movedim(1, -1).reshape(-1, m.size * m.chunk)


def segmented_sq_norms_plain(tensors: Sequence[torch.Tensor],
                             tab: Table) -> torch.Tensor:
    """Member by member, the members of a group added in order."""
    outs = []
    for _, _, m0, m1 in tab.groups:
        acc = None
        for m, v in zip(tab.members[m0:m1], tab.views[m0:m1]):
            s = group_l2_norms_plain(
                owned_2d(tensors[m.tensor], m, v).float().contiguous(), m.size)
            acc = s if acc is None else acc + s
        outs.append(acc)
    return torch.cat(outs)


def _grads_like(tensors, tab):
    return [torch.empty_like(t, memory_format=torch.contiguous_format)
            if c else torch.zeros_like(t, memory_format=torch.contiguous_format)
            for t, c in zip(tensors, tab.covered)]


def segmented_sq_norms_backward_plain(tensors: Sequence[torch.Tensor],
                                      tab: Table,
                                      g: torch.Tensor) -> List[torch.Tensor]:
    """``2 * w * g[unit]`` on every owned element, zero elsewhere."""
    grads = _grads_like(tensors, tab)
    for m, (outer, L, inner) in zip(tab.members, tab.views):
        span = m.size * m.chunk
        dw = grads[m.tensor].view(outer, L, inner).narrow(1, m.offset, span)
        w = tensors[m.tensor].reshape(outer, L, inner).narrow(1, m.offset,
                                                              span)
        gm = g[m.base:m.base + m.size].float().repeat_interleave(m.chunk)
        dw.copy_(2.0 * w.float() * gm[None, :, None])
    return grads


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _device_of(tensors, tab) -> torch.device:
    """The tensors' common device, after checking their shapes and
    dtypes against the table (one comparison: this runs every step)."""
    if [(t.shape, t.dtype) for t in tensors] != tab.leaves:
        raise ValueError(f"tensors {[(tuple(t.shape), t.dtype) for t in tensors]}"
                         f" where the table has {tab.leaves}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"the tensors are on {len(devices)} devices")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _pointers(tensors, tab):
    """The kernel's pointer table; raises on what the kernel does not
    take."""
    if any(dt not in DTYPES for _, dt in tab.leaves):
        raise ValueError("the kernel takes float32 or bfloat16 tensors")
    if len(tensors) > MAX_TENSORS:
        raise ValueError(f"{len(tensors)} tensors exceed the kernel's "
                         f"{MAX_TENSORS}")
    ptrs = [t.data_ptr() for t in tensors]
    if any(p % 16 for p in ptrs) or not all(t.is_contiguous()
                                            for t in tensors):
        raise ValueError("the kernel reads contiguous tensors that start "
                         "16-byte aligned")
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def segmented_sq_norms(tensors: Sequence[torch.Tensor],
                       tab: Table) -> torch.Tensor:
    """(units,) fp32 per-unit sums of squares of ``tab``'s members."""
    dev = _device_of(tensors, tab)
    if dev.type == "cpu":
        return segmented_sq_norms_plain(tensors, tab)
    out = torch.empty((tab.units,), dtype=torch.float32, device=dev)
    partial = torch.empty((max(tab.partial_len, 1),), dtype=torch.float32,
                          device=dev)
    nm, ni, ng, ni2 = tab.counts
    err = build.library().group_l2_fwd_launch(
        _pointers(tensors, tab), len(tensors), tab.on(dev).data_ptr(), nm, ni, ng,
        ni2, partial.data_ptr(), out.data_ptr(), build.stream_handle(dev))
    build.check(err, "group_l2_norms")
    group_l2_norms.launches += 1
    group_l2_norms.shapes[tab.signature] += 1
    return out


def segmented_sq_norms_backward(tensors: Sequence[torch.Tensor], tab: Table,
                                g: torch.Tensor) -> List[torch.Tensor]:
    """Each tensor's gradient for the cotangent ``g`` (units,) of
    :func:`segmented_sq_norms`, in the tensor's dtype."""
    dev = _device_of(tensors, tab)
    if g.shape != (tab.units,):
        raise ValueError(f"cotangent {tuple(g.shape)} for {tab.units} units")
    if dev.type == "cpu":
        return segmented_sq_norms_backward_plain(tensors, tab, g)
    g = g.to(device=dev, dtype=torch.float32).contiguous()
    grads = _grads_like(tensors, tab)
    nm, ni, _, _ = tab.counts
    err = build.library().group_l2_bwd_launch(
        _pointers(tensors, tab), _pointers(grads, tab), len(tensors),
        tab.on(dev).data_ptr(), nm, ni, g.data_ptr(), build.stream_handle(dev))
    build.check(err, "group_l2_norms backward")
    group_l2_norms.bwd_launches += 1
    group_l2_norms.bwd_shapes[tab.signature] += 1
    return grads


def group_l2_norms(w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """w (K, G*C) float32 or bfloat16 -> (G,) float32: the single-matrix
    form, one member of :func:`segmented_sq_norms`."""
    return segmented_sq_norms([w], single_table(
        w.shape, str(w.dtype).removeprefix("torch."), num_groups))


group_l2_norms.launches = 0
group_l2_norms.shapes = Counter()        # signature -> forward launches
group_l2_norms.bwd_launches = 0
group_l2_norms.bwd_shapes = Counter()    # signature -> backward launches


class SegmentedSqNorms(torch.autograd.Function):
    """Differentiable :func:`segmented_sq_norms` (module docstring)."""

    @staticmethod
    def forward(ctx, tab: Table, *tensors):
        ctx.tab = tab
        ctx.save_for_backward(*tensors)
        return segmented_sq_norms(tensors, tab)

    @staticmethod
    def backward(ctx, g):
        return (None, *segmented_sq_norms_backward(ctx.saved_tensors,
                                                   ctx.tab, g))
