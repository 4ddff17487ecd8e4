"""Model interface (``repro/models/model.py``): ``init`` dispatches on
``cfg.arch_type``; the U-Net branch trains (``loss_fn``), the decoder
branch serves (``prefill``, ``init_cache``, ``decode``,
``reset_cache_slots``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.diffusion.ddpm import ddpm_loss
from repro_torch.diffusion.schedule import linear_schedule
from repro_torch.models import transformer as tfm
from repro_torch.models.unet import Params, apply_unet, init_unet


def _require_unet(cfg: ModelConfig) -> None:
    if cfg.arch_type != "unet":
        raise NotImplementedError(f"the port trains U-Nets only; "
                                  f"{cfg.name!r} is {cfg.arch_type!r} "
                                  f"(LM training: ROADMAP A.13)")


def init(cfg: ModelConfig, generator: torch.Generator,
         device="cuda") -> Params:
    if cfg.arch_type == "unet":
        return init_unet(cfg, generator, device=device)
    return tfm.init_params(cfg, generator, device=device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, *,
            masks: Optional[Dict[str, torch.Tensor]] = None,
            clients: Optional[int] = None,
            t: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DDPM epsilon loss of one batch (``batch["images"]``), with t
    and eps drawn from ``generator`` unless given.  Training runs the
    U-Net without dropout, as the reference's loss does
    (``apply_unet(train=False)``).  ``masks``: the sparse-phase prune
    masks (PruneGroup name -> 0/1 row), applied as masked GEMMs.
    ``clients=C``: stacked params and C batches one after another; the
    result is the (C,) per-client losses."""
    _require_unet(cfg)
    x0 = batch["images"]
    schedule = linear_schedule(cfg.diffusion_steps, device=x0.device)
    return ddpm_loss(lambda x_t, tt: apply_unet(params, cfg, x_t, tt,
                                                masks=masks,
                                                clients=clients),
                     schedule, x0, generator, t=t, eps=eps, clients=clients)


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward; the last position's logits (B, V)."""
    hidden = tfm.forward(params, cfg, batch)
    return tfm.logits_from_hidden(params, cfg, hidden[:, -1:, :])[:, 0, :]


def init_cache(params: Params, cfg: ModelConfig, batch: int, seq_len: int):
    return tfm.init_cache(params, cfg, batch, seq_len)


def decode(params: Params, cache, cfg: ModelConfig, tokens: torch.Tensor):
    return tfm.decode_step(params, cache, cfg, tokens)


def reset_cache_slots(cache, fresh, reset: torch.Tensor):
    """Per-slot cache reset for continuous-batching refill (see
    :func:`repro_torch.models.transformer.reset_cache_slots`)."""
    return tfm.reset_cache_slots(cache, fresh, reset)
