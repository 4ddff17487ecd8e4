"""Device meshes (``repro/launch/mesh.py``), one process a device.

The reference is single-controller: one process sees every device and
``jit`` partitions one program over a ``jax`` mesh.  The port runs one
process a device, as PyTorch does: ``torchrun --nproc-per-node N`` (or a
world of one started here), a
:class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
axis names, and collectives on the process group of one mesh dimension
(``mesh.get_group("data")``).  Every rank runs the same host code from
the same seeds, so the host streams (selection, shuffles, faults) agree
on every rank without a message; the mesh shards only the device work.

Topology, as the reference maps it: "pod" is the slow tier between
nodes (FedPhD's cloud aggregation), "data" x "model" the fast tiers
within one (edge aggregation, tensor sharding); on H100s, NVLink within
a node and the network between nodes (:mod:`repro_torch.roofline.hw`).

Each constructor starts a process group where none exists: under
``torchrun`` (``WORLD_SIZE`` in the environment) from the environment,
else a world of one over a :class:`torch.distributed.HashStore`.  The
backend is NCCL for ``device="cuda"`` (the default, as for every entry
point) and gloo for ``device="cpu"``; a CUDA mesh without a card or
without NCCL raises and never falls back to gloo or the CPU.  Under
``torchrun`` each rank's card is ``cuda:$LOCAL_RANK``, set current
before the group starts (otherwise every rank would use ``cuda:0``).
"""
from __future__ import annotations

import math
import os
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist


def _device_type(device) -> str:
    return torch.device(device).type


def init_world(device="cuda") -> int:
    """The world's size, after making sure a process group exists whose
    backend serves ``device`` (see the module docstring)."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was requested but torch.cuda "
                               "is not available; pass device='cpu' for "
                               "a gloo mesh on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch "
                               "build lacks")
        index = dev.index if dev.index is not None \
            else int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(index)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:            # launched by torchrun
            dist.init_process_group(backend)
        else:                                     # alone: a world of one
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    elif backend not in dist.get_backend():
        raise RuntimeError(f"the process group's backend is "
                           f"{dist.get_backend()!r}, which cannot serve a "
                           f"{dev.type!r} mesh (needs {backend!r})")
    return dist.get_world_size()


def destroy_world() -> None:
    """Tear down the default process group, if one exists."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_writer() -> bool:
    """Whether this process writes a run's files (spec, checkpoints,
    metrics, reports, traces): rank 0 of its world, read from the
    process group or, before one starts, from ``torchrun``'s ``RANK``; a
    process alone always writes."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", 0)) == 0


def _mesh(device, sizes: Sequence[int], names: Sequence[str]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), tuple(sizes),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production layout: ("data", "model") = (16, 16),
    or ("pod", "data", "model") = (2, 16, 16).  Raises, with both
    counts, on a world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = init_world(device)
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs "
            f"{math.prod(shape)} ranks but the world has {world}")
    return _mesh(device, shape, axes)


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """("data", "model") = (world // model_axis, model_axis) over every
    rank.  ``model_axis`` must divide the world exactly: integer
    division would silently build a mesh over fewer ranks than the world
    has, and every collective after that would be wrong about who its
    peers are."""
    n = init_world(device)
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(
            f"model_axis={model_axis} does not divide the {n} available "
            f"device(s); an uneven split would silently drop "
            f"{n % model_axis if model_axis >= 1 else n} of them")
    return _mesh(device, (n // model_axis, model_axis), ("data", "model"))


def make_spec_mesh(axes: Optional[Mapping[str, int]], device="cuda"):
    """A mesh from ``ExperimentSpec.mesh`` ({axis name -> size}).

    Insertion order is the axis order and size-1 axes are kept (so a
    spec like ``{"data": 8, "model": 1}`` documents the intended
    layout); None or ``{}`` means no mesh.  The sizes' product must
    equal the world's size: a larger one raises with the ``torchrun``
    command that would start it, and so does a smaller one, because a
    rank outside the mesh would have nothing to do (the single-
    controller reference has no such rank: it takes the first
    prod(sizes) devices and leaves the rest idle in one process)."""
    if not axes:
        return None
    names = tuple(axes)
    sizes = tuple(int(axes[k]) for k in names)
    if any(s < 1 for s in sizes):
        raise ValueError(f"spec.mesh sizes must be >= 1: {dict(axes)}")
    need = math.prod(sizes)
    world = init_world(device)
    if need > world:
        raise ValueError(
            f"spec.mesh {dict(axes)} needs {need} device(s) but the world "
            f"has {world} rank(s) (hint: start one process a device with "
            f"torchrun --nproc-per-node {need})")
    if need < world:
        raise ValueError(
            f"spec.mesh {dict(axes)} covers {need} of the world's {world} "
            f"ranks; the ranks outside it would have nothing to do")
    return _mesh(device, sizes, names)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} in the mesh's axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
