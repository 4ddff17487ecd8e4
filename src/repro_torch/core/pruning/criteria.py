"""Pruning criteria (``repro/core/pruning/criteria.py``): L2 group norm
(paper §IV-A) and random (FedPhD-OS).

The per-unit sums of squares (the Eq. 17 inner term, shared with the
Omega regularizer) take two routes, as the reference's do.  Every
member of every group that is not scan-stacked goes through one
segmented group sum-of-squares launch (:func:`sq_norms`, the
kernel :mod:`repro_torch.kernels.group_l2_norms.ops`), where the
reference calls its Pallas kernel: the launch's table is built once per
group list and parameter shapes and dtypes, and only the tensors are
gathered on each call (the parameters are new tensors after every Adam
step).  A member that owns two axes of one tensor (the RG-LRU's gate
matrices) is two entries of the launch over that tensor, so that its
gradient is the sum of the two.  Members of stacked groups keep their
leading cycle axis and are reduced in plain tensor ops, as the
reference's are.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.pruning.groups import PruneGroup, get_path
from repro_torch.kernels.group_l2_norms import ops as gl2
from repro_torch.models import ops


def _slots(flat: Sequence[PruneGroup]) -> Tuple[tuple, ...]:
    """The launch's tensors: the distinct (path, axis) of the unstacked
    groups' members, in first-use order."""
    slots = tuple(dict.fromkeys((m.path, m.axis) for g in flat
                                for m in g.members))
    if len(slots) > gl2.MAX_TENSORS:
        raise ValueError(f"the unstacked groups' members span {len(slots)} "
                         f"tensors; one group-L2 launch takes at most "
                         f"{gl2.MAX_TENSORS}")
    return slots


def _table(flat: Tuple[PruneGroup, ...], slots, leaves,
           clients: Optional[int] = None) -> gl2.Table:
    """The launch's table for the unstacked groups ``flat`` over tensors
    of ``leaves`` ((shape, dtype) per slot of :func:`_slots`, one
    client's)."""
    index = {s: i for i, s in enumerate(slots)}
    members, base = [], 0
    for g in flat:
        members += [gl2.Member(index[m.path, m.axis], m.axis, m.offset,
                               m.chunk, g.size, base) for m in g.members]
        base += g.size
    names = tuple((tuple(shape), str(dt).removeprefix("torch."))
                  for shape, dt in leaves)
    return gl2.table((names, tuple(members)), clients)


@functools.lru_cache(maxsize=16)
def _layout(groups: Tuple[PruneGroup, ...]):
    """(unstacked groups, stacked groups, launch slots, {leaves: table})
    of a group list, so that the groups, the costly part of the key, are
    hashed once a call."""
    flat = tuple(g for g in groups if not g.stacked)
    stacked = tuple(g for g in groups if g.stacked)
    return flat, stacked, _slots(flat), {}


def _checked_layout(groups: Sequence[PruneGroup], clients: Optional[int]):
    layout = _layout(tuple(groups))
    stacked = layout[1]
    if clients is not None and stacked:
        raise ValueError(f"clients={clients} with the scan-stacked group "
                         f"{stacked[0].name!r}: the client axis stacks "
                         f"U-Net parameters only")
    return layout


def _launch_inputs(params, layout, clients: Optional[int]
                   ) -> Tuple[List[torch.Tensor], gl2.Table]:
    flat, _, slots, tables = layout
    tensors = [get_path(params, path) for path, _ in slots]
    skip = 0 if clients is None else 1
    leaves = tuple((t.shape[skip:], t.dtype) for t in tensors)
    tab = tables.get((leaves, clients))
    if tab is None:
        tab = tables[leaves, clients] = _table(flat, slots, leaves, clients)
    return tensors, tab


def member_table(params, groups: Sequence[PruneGroup],
                 clients: Optional[int] = None
                 ) -> Tuple[List[torch.Tensor], gl2.Table]:
    """The tensors and the table of the one launch over the unstacked
    members of ``groups``; with ``clients=C`` the params are stacked
    (C, ...) and the table has a client axis (no group may be
    scan-stacked then)."""
    return _launch_inputs(params, _checked_layout(groups, clients), clients)


def _stacked_sq(params, g: PruneGroup) -> torch.Tensor:
    """(stacked, size) float32 sums of squares of a stacked group, each
    member's cycle axis kept."""
    out = None
    for m in g.members:
        axis = m.axis + 1
        sl = get_path(params, m.path).narrow(axis, m.offset,
                                             g.size * m.chunk)
        shape = list(sl.shape)
        shape[axis:axis + 1] = [g.size, m.chunk]
        r = sl.reshape(shape).float()
        s = torch.sum(torch.square(r), dim=tuple(
            i for i in range(r.dim()) if i not in (0, axis)))
        out = s if out is None else out + s
    return out


def sq_norms(params, groups: Sequence[PruneGroup],
             clients: Optional[int] = None
             ) -> Tuple[Optional[torch.Tensor], Dict[str, torch.Tensor]]:
    """float32 ||theta^g[k]||_2^2 of every unit, differentiable: the
    unstacked groups' (sum of their sizes,), one after another, from one
    launch (None if there are none), and each stacked group's
    (stacked, size) by name, in plain ops.  ``clients=C``: stacked
    params, (C * sum of sizes,), client after client; no group may be
    scan-stacked then."""
    layout = _checked_layout(groups, clients)
    flat_sq = ops.segmented_sq_norms(
        *_launch_inputs(params, layout, clients)) if layout[0] else None
    return flat_sq, {g.name: _stacked_sq(params, g) for g in layout[1]}


def l2_scores(params, groups: List[PruneGroup]) -> Dict[str, torch.Tensor]:
    """Group-norm importance scores (sqrt of summed squares), (size,) or
    (stacked, size) a group: one launch for the unstacked groups, plain
    ops for the stacked ones."""
    flat_sq, stacked = sq_norms(params, groups)
    out = {k: torch.sqrt(v) for k, v in stacked.items()}
    if flat_sq is not None:
        flat = [g for g in groups if not g.stacked]
        out.update(zip((g.name for g in flat), torch.sqrt(flat_sq).split(
            [g.size for g in flat])))
    return {g.name: out[g.name] for g in groups}


def random_scores(generator: torch.Generator, groups: List[PruneGroup],
                  device="cuda") -> Dict[str, torch.Tensor]:
    """FedPhD-OS one-shot random scores, (stacked, size) for a stacked
    group (a torch stream: not the reference's jax.random draws)."""
    return {g.name: torch.rand((g.stacked, g.size) if g.stacked
                               else (g.size,), generator=generator,
                               device=device)
            for g in groups}
