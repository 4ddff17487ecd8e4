"""Sampling front-end for trained diffusion U-Nets
(``repro/diffusion/sampling.py``): DDIM from a prior drawn from the
caller's seed, as the experiment API's eval hook and callers outside the
server sample."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.diffusion.ddim import ddim_sample
from repro_torch.diffusion.schedule import linear_schedule


@torch.no_grad()
def sample_images(params, cfg: ModelConfig, n: int = 64, steps: int = 10,
                  seed: int = 0, *, masks=None, eta: float = 0.0,
                  device=None) -> np.ndarray:
    """DDIM-sample ``n`` images (N, H, W, C) from a trained U-Net.

    x_T (and, for ``eta > 0``, each step's noise) comes from a
    ``torch.Generator`` of its own, seeded by ``seed`` on ``device``
    (default: the parameters' device); no other generator advances.
    ``masks``: optional sparse-phase prune masks (``make_masks`` output
    keyed by PruneGroup name), applied as masked GEMMs, the same
    numbers as sampling from ``apply_masks``-zeroed weights.  The
    forward runs the kernels on a CUDA device: every GEMM is the matmul
    kernel, every attention block the attention kernel at BH = n."""
    from repro_torch.models.unet import apply_unet
    from repro_torch.tree import tree_leaves, tree_map
    dev = tree_leaves(params)[0].device if device is None \
        else torch.device(device)
    params = tree_map(lambda p: torch.as_tensor(p, device=dev), params)
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    shape = (n, cfg.image_size, cfg.image_size, cfg.in_channels)
    out = ddim_sample(
        lambda x, t: apply_unet(params, cfg, x, t, masks=masks),
        linear_schedule(cfg.diffusion_steps, device=dev), shape,
        num_steps=steps, eta=eta, generator=gen)
    return out.cpu().numpy()
