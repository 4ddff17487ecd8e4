"""U-Net config registry (the port serves and trains the paper's DDPM
U-Nets) and the federated-learning config."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.ddpm_unet import CELEBA_UNET, CIFAR10_UNET, SMOKE_UNET

UNETS: Dict[str, ModelConfig] = {
    "ddpm-unet-cifar10": CIFAR10_UNET,
    "ddpm-unet-celeba": CELEBA_UNET,
    "ddpm-unet-smoke": SMOKE_UNET,
}


def get_config(name: str) -> ModelConfig:
    if name not in UNETS:
        raise KeyError(f"unknown U-Net config {name!r}; available: "
                       f"{sorted(UNETS)}")
    return UNETS[name]


__all__ = ["CELEBA_UNET", "CIFAR10_UNET", "SMOKE_UNET", "UNETS",
           "FLConfig", "ModelConfig", "get_config"]
