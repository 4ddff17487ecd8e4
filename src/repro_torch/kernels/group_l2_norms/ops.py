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

A client axis: ``table(signature, clients=C)`` lays out one launch over
stacked tensors, each the signature's tensor with a leading (C,) axis
(the vectorized round engine's parameters).  Its output is (C * units,),
client after client; each client's work items are the one-client items
shifted, so a client's sums and gradient are the bits of a one-client
launch on its slice.

Every forward launch counts in ``group_l2_norms.launches`` and, by the
table's ``key`` (its signature, with C appended for a client axis), in
``group_l2_norms.shapes``; backward launches in
``group_l2_norms.bwd_launches`` and ``.bwd_shapes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

MAX_TENSORS = 240            # the kernel's by-value pointer table (csrc)
MREC = 18                    # ints per member record (csrc's Member)
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
    clients: Optional[int]        # C of a client axis, or None
    leaves: List[tuple]           # (shape, torch dtype) per tensor
    units: int                    # per client
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

    @property
    def key(self):
        """The launch tally's key: the signature, with C appended for a
        client axis."""
        return self.signature if self.clients is None \
            else self.signature + (self.clients,)

    @property
    def out_units(self) -> int:
        """The output's length: units, times C for a client axis."""
        return self.units * (self.clients or 1)

    def member_bytes(self) -> int:
        """Bytes of every member element, each read once (every
        client's)."""
        return (self.clients or 1) * sum(
            math.prod(self.signature[0][m.tensor][0])
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
def table(signature: Signature, clients: Optional[int] = None) -> Table:
    """Validate ``signature`` and lay out its launch: a member record
    per member (the order ``csrc``'s ``Member`` reads), a work item per
    (member, row slab, column or unit tile) of about ITEM_BYTES, a group
    record per run of members with one base, and a pass-2 item per 256
    units of a group.  With ``clients=C`` the tensors carry a leading
    (C,) axis and every record is repeated for each client
    (:func:`_for_clients`)."""
    if clients is not None:
        if clients < 1:
            raise ValueError(f"clients={clients}: want at least 1")
        return _for_clients(table(signature), clients)
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
                     plen, pstride, pr, nslabs, rows, ncols, 0, 0])
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
    return Table(signature=signature, clients=None, leaves=leaves,
                 units=units, views=tuple(views),
                 groups=tuple(map(tuple, groups)), covered=tuple(covered),
                 desc=desc, counts=(len(mrec), len(items), len(groups),
                                    len(items2)), partial_len=plen)


def _for_clients(one: Table, C: int) -> Table:
    """``one``'s layout repeated for C clients of stacked tensors: copy c
    of a member reads from element ``c * numel`` of its tensor (numel:
    one client's elements; a 64-bit offset in record ints 16-17), writes
    units ``c * units + base`` and partials ``c * partial_len + pbase``;
    copy c of an item, group or pass-2 item names copy c of its member
    or group.  16-byte loads need every client's slice aligned, so a
    member of a tensor whose numel is not a multiple of 4 loses them."""
    nm, ni, ng, ni2 = one.counts
    d = one.desc
    mrec = d[:MREC * nm].reshape(nm, MREC).astype(np.int64)
    items = d[MREC * nm:MREC * nm + 4 * ni].reshape(ni, 4)
    groups = d[MREC * nm + 4 * ni:MREC * nm + 4 * (ni + ng)].reshape(ng, 4)
    items2 = d[MREC * nm + 4 * (ni + ng):].reshape(ni2, 4)
    numel = np.asarray([math.prod(one.signature[0][t][0])
                        for t in mrec[:, 0]], np.int64)
    mrec[:, 3] &= numel % 4 == 0
    copies = {"m": [], "i": [], "g": [], "i2": []}
    for c in range(C):
        m = mrec.copy()
        m[:, 9] += c * one.units
        m[:, 10] += c * one.partial_len
        off = c * numel
        m[:, 16] = off & 0xFFFFFFFF
        m[:, 17] = off >> 32
        copies["m"].append(m.astype(np.uint32).view(np.int32))
        copies["i"].append(items + np.asarray([c * nm, 0, 0, 0], np.int32))
        copies["g"].append(groups + np.asarray(
            [c * one.units, 0, c * nm, c * nm], np.int32))
        copies["i2"].append(items2 + np.asarray([c * ng, 0, 0, 0], np.int32))
    desc = np.concatenate([np.concatenate(copies[k]).reshape(-1)
                           for k in ("m", "i", "g", "i2")])
    return dataclasses.replace(
        one, clients=C, desc=desc,
        leaves=[((C,) + tuple(shape), dt) for shape, dt in one.leaves],
        counts=(C * nm, C * ni, C * ng, C * ni2),
        partial_len=C * one.partial_len, _on_device={})


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
    """Member by member, the members of a group added in order; with a
    client axis, client after client."""
    if tab.clients is not None:
        one = table(tab.signature)
        return torch.cat([segmented_sq_norms_plain([t[c] for t in tensors],
                                                   one)
                          for c in range(tab.clients)])
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
    C = tab.clients
    for c in range(C or 1):
        ts = tensors if C is None else [t[c] for t in tensors]
        gs = grads if C is None else [d[c] for d in grads]
        gc = g[c * tab.units:(c + 1) * tab.units]
        for m, (outer, L, inner) in zip(tab.members, tab.views):
            span = m.size * m.chunk
            dw = gs[m.tensor].view(outer, L, inner).narrow(1, m.offset, span)
            w = ts[m.tensor].reshape(outer, L, inner).narrow(1, m.offset,
                                                             span)
            gm = gc[m.base:m.base + m.size].float().repeat_interleave(
                m.chunk)
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
    """(units,) fp32 per-unit sums of squares of ``tab``'s members
    ((C * units,) with a client axis)."""
    dev = _device_of(tensors, tab)
    if dev.type == "cpu":
        return segmented_sq_norms_plain(tensors, tab)
    out = torch.empty((tab.out_units,), dtype=torch.float32, device=dev)
    partial = torch.empty((max(tab.partial_len, 1),), dtype=torch.float32,
                          device=dev)
    nm, ni, ng, ni2 = tab.counts
    err = build.library().group_l2_fwd_launch(
        _pointers(tensors, tab), len(tensors), tab.on(dev).data_ptr(), nm, ni, ng,
        ni2, partial.data_ptr(), out.data_ptr(), build.stream_handle(dev))
    build.check(err, "group_l2_norms")
    group_l2_norms.launches += 1
    group_l2_norms.shapes[tab.key] += 1
    return out


def segmented_sq_norms_backward(tensors: Sequence[torch.Tensor], tab: Table,
                                g: torch.Tensor) -> List[torch.Tensor]:
    """Each tensor's gradient for the cotangent ``g`` (units,) of
    :func:`segmented_sq_norms`, in the tensor's dtype."""
    dev = _device_of(tensors, tab)
    if g.shape != (tab.out_units,):
        raise ValueError(f"cotangent {tuple(g.shape)} for {tab.out_units} "
                         f"units")
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
    group_l2_norms.bwd_shapes[tab.key] += 1
    return grads


def group_l2_norms(w: torch.Tensor, num_groups: int) -> torch.Tensor:
    """w (K, G*C) float32 or bfloat16 -> (G,) float32: the single-matrix
    form, one member of :func:`segmented_sq_norms`."""
    return segmented_sq_norms([w], single_table(
        w.shape, str(w.dtype).removeprefix("torch."), num_groups))


group_l2_norms.launches = 0
group_l2_norms.shapes = Counter()        # table key -> forward launches
group_l2_norms.bwd_launches = 0
group_l2_norms.bwd_shapes = Counter()    # table key -> backward launches


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
