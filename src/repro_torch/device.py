"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    missing (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' (--device cpu) "
                           "to run the plain versions on the CPU")
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
