"""Model interface (``repro/models/model.py``), the U-Net branch: the
port trains only the paper's DDPM U-Net."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.diffusion.ddpm import ddpm_loss
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.models.unet import Params, apply_unet, init_unet


def _require_unet(cfg: ModelConfig) -> None:
    if cfg.arch_type != "unet":
        raise NotImplementedError(f"the port trains U-Nets only; "
                                  f"{cfg.name!r} is {cfg.arch_type!r}")


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    _require_unet(cfg)
    return init_unet(cfg, generator, device=device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            generator: torch.Generator) -> torch.Tensor:
    """The DDPM epsilon loss of one batch (``batch["images"]``), with t
    and eps drawn from ``generator``.  Training runs the U-Net without
    dropout, as the reference's loss does (``apply_unet(train=False)``)."""
    _require_unet(cfg)
    x0 = batch["images"]
    schedule = linear_schedule(cfg.diffusion_steps, device=x0.device)
    return ddpm_loss(lambda x_t, t: apply_unet(params, cfg, x_t, t),
                     schedule, x0, generator)
