"""FedPhD's hierarchy mapped onto the mesh (``repro/launch/federated.py``).

On a machine of several nodes the paper's two aggregation tiers are the
two bandwidth tiers: edge aggregation is an all-reduce within a node
over NVLink (cheap, every r_e rounds), cloud aggregation one between
nodes over the network (dear, every r_g rounds).  Each rank of the
"data" axis plays one client (or a block of clients), and a "pod" one
edge server.

The collectives move buckets: every leaf of one output, flattened in
tree order into one buffer, so an output is one collective however many
leaves it has (the full-width U-Net has 304).  :data:`COLLECTIVES`
counts them and the bytes each rank sends.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.aggregation import cast_like
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.roofline import hw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the mesh axis whose ranks share a round's clients
CLIENT_AXIS = "data"

# collectives run by this module since the last reset: kind -> count, and
# "<kind>_bytes" -> the bytes each rank put in
COLLECTIVES = {"all_reduce": 0, "all_reduce_bytes": 0,
               "all_gather": 0, "all_gather_bytes": 0}

_WARNED_INDIVISIBLE = False
# all_gather_into_tensor's newer name, where the installed torch has it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def require_client_axis(mesh) -> None:
    """Refuse a mesh that cannot shard a round's clients: one without
    :data:`CLIENT_AXIS` would leave every rank training all of them."""
    if mesh is not None and CLIENT_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"a trainer's mesh needs a {CLIENT_AXIS!r} axis to shard the "
            f"round's clients over; got axes {mesh.mesh_dim_names}")


def client_rows(mesh, n_rows: int) -> Optional[Tuple[int, int]]:
    """``(lo, hi)``, this rank's block of ``n_rows`` clients on
    :data:`CLIENT_AXIS`, or None where there is no mesh or the axis size
    does not divide ``n_rows`` (the round then runs unsharded)."""
    if mesh is None:
        return None
    require_client_axis(mesh)
    n = mesh_axis_sizes(mesh)[CLIENT_AXIS]
    if n_rows % n != 0:
        return None
    pos = dist.get_rank(mesh.get_group(CLIENT_AXIS))
    m = n_rows // n
    return pos * m, (pos + 1) * m


def shard_clients(tree, mesh, axis: str = CLIENT_AXIS):
    """This rank's block of the leading client axis of every leaf, as a
    view (torch or numpy leaves).

    The bridge between the vectorized round engine and the mesh: a rank
    holds, uploads and trains only its block of the round's clients.
    A leaf whose leading dimension does not divide the axis size is
    returned whole, and the first such leaf warns once a process, so a
    participant count that silently defeats the mesh is visible; 0-d
    leaves have no client axis and pass quietly.  A None mesh, or one
    without ``axis``, gives the tree back."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return tree
    n_dev = mesh_axis_sizes(mesh)[axis]
    pos = dist.get_rank(mesh.get_group(axis))

    def put(leaf):
        global _WARNED_INDIVISIBLE
        if leaf.ndim == 0:
            return leaf
        if leaf.shape[0] % n_dev != 0:
            if not _WARNED_INDIVISIBLE:
                warnings.warn(
                    f"shard_clients: a leaf's leading dim "
                    f"({leaf.shape[0]}) does not divide mesh axis "
                    f"{axis!r} (size {n_dev}); leaving it UNSHARDED. "
                    "Pick a participant count divisible by the data-axis "
                    "size to keep the round on the mesh. (warning once "
                    "per process)", RuntimeWarning)
                _WARNED_INDIVISIBLE = True
            return leaf
        m = leaf.shape[0] // n_dev
        return leaf[pos * m:(pos + 1) * m]
    return tree_map(put, tree)


def _flat(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in leaves])


def reduce_tree(tree, group):
    """``tree`` (fp32 leaves) summed over ``group``: one all-reduce of
    one flat fp32 bucket in tree order; the result's leaves are views of
    the bucket."""
    leaves = tree_leaves(tree)
    bucket = _flat([x.float() for x in leaves])
    dist.all_reduce(bucket, group=group)
    COLLECTIVES["all_reduce"] += 1
    COLLECTIVES["all_reduce_bytes"] += bucket.numel() * 4
    out, off = [], 0
    for x in leaves:
        out.append(bucket[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return tree_unflatten(tree, out)


def gather_rows(tree, group):
    """Every rank's rows of ``tree`` (leaves (m, ...), any dtype) as
    (n m, ...) leaves in rank order: one all-gather of one byte bucket
    in tree order, so each value arrives bit for bit."""
    leaves = tree_leaves(tree)
    n = dist.get_world_size(group)
    mine = _flat([x.contiguous().reshape(-1).view(torch.uint8)
                  for x in leaves])
    every = mine.new_empty((n * mine.numel(),))
    _all_gather(every, mine, group=group)
    every = every.view(n, mine.numel())
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["all_gather_bytes"] += mine.numel()
    out, off = [], 0
    for x in leaves:
        nb = x.numel() * x.element_size()
        rows = every[:, off:off + nb].contiguous().view(x.dtype)
        out.append(rows.reshape((n * x.shape[0],) + tuple(x.shape[1:])))
        off += nb
    return tree_unflatten(tree, out)


def _sh_weight(n, mu, a: float, b: float):
    return torch.clamp(n + a * mu + b, min=0.0)


def hierarchical_aggregate(params, n_samples, sh_score, *, mesh,
                           edge_axis: str = "data", cloud_axis: str = "pod",
                           a: float = 0.0, b: float = 0.0,
                           cloud_round: bool = True):
    """Two-tier homogeneity-aware aggregation (paper Eqs. 21-24).

    One client a rank: ``params`` is this rank's client model,
    ``n_samples`` and ``sh_score`` its sample count and SH score (Eq.
    18).  The weight is ``w = relu(n + a mu + b)``; the edge tier is
    ``sum leaf w / sum w`` over ``edge_axis``; on a cloud round each
    edge's ``n_e = sum w`` and ``mu_e = sum(mu w) / sum w`` weigh its
    aggregate the same way over ``cloud_axis``.  Each tier is one
    all-reduce of one fp32 bucket holding the weight sums and the
    weighted leaves in tree order.  Returns the aggregate, the same on
    every rank of the group, in the leaves' dtypes."""
    names = mesh.mesh_dim_names
    axes = [x for x in (edge_axis, cloud_axis) if x in names]
    leaves = tree_leaves(params)
    dev = leaves[0].device
    scalar = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                       device=dev).reshape(1)
    n, mu = scalar(n_samples), scalar(sh_score)
    w = _sh_weight(n, mu, a, b)
    # --- edge tier: within a node over the data axis (Eq. 23/24)
    edge = reduce_tree([w, mu * w] + [x.float() * w for x in leaves],
                       mesh.get_group(axes[0]))
    wsum, agg = edge[0], [x / edge[0] for x in edge[2:]]
    if cloud_round and cloud_axis in names:
        # --- cloud tier: between nodes over the pod axis (Eq. 21/22)
        w_c = _sh_weight(wsum, edge[1] / wsum, a, b)
        cloud = reduce_tree([w_c] + [x * w_c for x in agg],
                            mesh.get_group(cloud_axis))
        agg = [x / cloud[0] for x in cloud[1:]]
    return tree_unflatten(params, [cast_like(x, leaf.dtype)
                                   for x, leaf in zip(agg, leaves)])


def federated_round_cost(model_bytes: int, *, n_pods: int = 2,
                         clients_per_pod: int = 256,
                         cloud_round: bool) -> dict:
    """Analytic traffic of one round of the mapped hierarchy, a ring
    all-reduce's bytes a rank, as the reference counts them.  ``ici``
    (the reference's inter-chip interconnect) stands for NVLink within a
    node and ``dcn`` (its data-center network) for the network between
    nodes; the seconds divide by the H100's rates
    (:mod:`repro_torch.roofline.hw`)."""
    ici = 2 * model_bytes * (clients_per_pod - 1) / clients_per_pod
    dcn = 2 * model_bytes * (n_pods - 1) / n_pods if cloud_round else 0.0
    return {"ici_bytes": ici, "dcn_bytes": dcn,
            "ici_s": ici / hw.NVLINK_BW, "dcn_s": dcn / hw.NET_BW}
