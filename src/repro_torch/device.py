"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda", mesh=None) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    missing (the port never moves to the CPU on its own).  With a
    ``mesh`` (a ``DeviceMesh``) it is this rank's device of the mesh,
    whose type must be ``device``'s: a CUDA mesh's rank trains on its
    current card (``cuda:$LOCAL_RANK`` under ``torchrun``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' (--device cpu) "
                           "to run the plain versions on the CPU")
    if mesh is None:
        return dev
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, not {mesh!r}: "
                        f"repro_torch.launch.mesh.make_spec_mesh builds one "
                        f"from {{axis: size}}")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is a {mesh.device_type!r} mesh but "
                         f"the trainer's device is {dev.type!r}")
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to_device(a, device) -> torch.Tensor:
    """A host (numpy) array as a tensor on ``device``, without blocking
    the host: on a CUDA device through a pinned copy and an asynchronous
    upload (a copy from pageable memory waits for the stream to drain,
    which would serialize a pipelined round behind the one before it;
    the caching host allocator keeps the pinned block until its upload
    is done).  Elsewhere ``torch.as_tensor``, which may share the
    array's memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a).pin_memory().to(device, non_blocking=True)
