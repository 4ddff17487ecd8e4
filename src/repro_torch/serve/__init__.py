"""Pruned-diffusion sampling service on the port's kernels.

  python -m repro_torch.serve --ckpt out/ckpt --requests 16 --slots 8
"""
from repro_torch.serve.artifact import load_serving_artifact, masks_for_ratio
from repro_torch.serve.server import DiffusionServer, Request, ServeResult

__all__ = ["DiffusionServer", "Request", "ServeResult",
           "load_serving_artifact", "masks_for_ratio"]
