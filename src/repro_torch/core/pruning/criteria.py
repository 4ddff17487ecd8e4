"""Pruning criteria (``repro/core/pruning/criteria.py``): L2 group norm
(paper §IV-A) and random (FedPhD-OS).

Every member of every group goes through one segmented group
sum-of-squares launch (:func:`unit_sq_norms`, the kernel
:mod:`repro_torch.kernels.group_l2_norms.ops`): its table of members is
built once per group list and parameter shapes and dtypes, and only the
tensors are gathered on each call (the parameters are new tensors after
every Adam step).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.pruning.groups import PruneGroup, get_path
from repro_torch.kernels.group_l2_norms import ops as gl2
from repro_torch.models import ops


def _check_unstacked(g: PruneGroup) -> None:
    if g.stacked:
        raise ValueError(f"group {g.name!r} is scan-stacked; the port's "
                         f"U-Net groups never are")


def _paths(groups: Sequence[PruneGroup]) -> Tuple[tuple, ...]:
    """The groups' distinct member paths, in first-use order."""
    for g in groups:
        _check_unstacked(g)
    return tuple(dict.fromkeys(m.path for g in groups
                               for m in g.members))


def _table(groups: Tuple[PruneGroup, ...], leaves,
           clients: Optional[int] = None) -> gl2.Table:
    """The launch's table for ``groups`` over tensors of ``leaves``
    ((shape, dtype) per path of :func:`_paths`, one client's)."""
    index = {p: i for i, p in enumerate(_paths(groups))}
    members, base = [], 0
    for g in groups:
        members += [gl2.Member(index[m.path], m.axis, m.offset, m.chunk,
                               g.size, base) for m in g.members]
        base += g.size
    names = tuple((tuple(shape), str(dt).removeprefix("torch."))
                  for shape, dt in leaves)
    return gl2.table((names, tuple(members)), clients)


@functools.lru_cache(maxsize=16)
def _layout(groups: Tuple[PruneGroup, ...]):
    """(paths, {leaves: table}) of a group list, so that the groups, the
    costly part of the key, are hashed once a call."""
    return _paths(groups), {}


def member_table(params, groups: Sequence[PruneGroup],
                 clients: Optional[int] = None
                 ) -> Tuple[List[torch.Tensor], gl2.Table]:
    """The tensors and the table of one launch over ``groups``; with
    ``clients=C`` the params are stacked (C, ...) and the table has a
    client axis."""
    groups = tuple(groups)
    paths, tables = _layout(groups)
    tensors = [get_path(params, p) for p in paths]
    skip = 0 if clients is None else 1
    leaves = tuple((t.shape[skip:], t.dtype) for t in tensors)
    tab = tables.get((leaves, clients))
    if tab is None:
        tab = tables[leaves, clients] = _table(groups, leaves, clients)
    return tensors, tab


def unit_sq_norms(params, groups: Sequence[PruneGroup],
                  clients: Optional[int] = None) -> torch.Tensor:
    """(sum of sizes,) float32 ||theta^g[k]||_2^2 of every unit of every
    group, the groups one after another; differentiable.  ``clients=C``:
    stacked params, (C * sum of sizes,), client after client."""
    return ops.segmented_sq_norms(*member_table(params, groups, clients))


def l2_scores(params, groups: List[PruneGroup]) -> Dict[str, torch.Tensor]:
    """Group-norm importance scores (sqrt of summed squares)."""
    scores = torch.sqrt(unit_sq_norms(params, groups))
    return dict(zip((g.name for g in groups),
                    scores.split([g.size for g in groups])))


def random_scores(generator: torch.Generator, groups: List[PruneGroup],
                  device="cuda") -> Dict[str, torch.Tensor]:
    """FedPhD-OS one-shot random scores (a torch stream: not the
    reference's jax.random draws)."""
    return {g.name: torch.rand((g.size,), generator=generator, device=device)
            for g in groups}
