"""Config registry: the paper's DDPM U-Nets, the decoder LMs the port
serves, their reduced smoke variants, and the federated-learning
config."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.ddpm_unet import CELEBA_UNET, CIFAR10_UNET, SMOKE_UNET
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b

UNETS: Dict[str, ModelConfig] = {
    "ddpm-unet-cifar10": CIFAR10_UNET,
    "ddpm-unet-celeba": CELEBA_UNET,
    "ddpm-unet-smoke": SMOKE_UNET,
}

# the reference's other decoder configs wait for their layer kinds
# (ROADMAP A.13)
ARCHS: Dict[str, ModelConfig] = {
    "recurrentgemma-9b": _recurrentgemma_9b,
}

ALL_CONFIGS: Dict[str, ModelConfig] = {**ARCHS, **UNETS}


def get_config(name: str) -> ModelConfig:
    if name not in ALL_CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: "
                       f"{sorted(ALL_CONFIGS)}")
    return ALL_CONFIGS[name]


def register_config(name: str, cfg: ModelConfig, *,
                    overwrite: bool = False) -> None:
    """Add a model config that ``spec.model`` can name (the reference's
    ``register_config``).  A spawned sweep worker imports the registry
    afresh and sees only the built-in configs."""
    if name in ALL_CONFIGS and not overwrite:
        raise ValueError(f"config {name!r} already registered "
                         "(pass overwrite=True to replace)")
    ALL_CONFIGS[name] = cfg


def smoke_variant(name: str) -> ModelConfig:
    """The reference's reduced variant (``repro/configs/__init__.py:
    smoke_variant``) for the decoder fields this port reads: one pattern
    cycle, d_model 256, 32-wide heads, d_ff <= 512, vocab <= 1024, window
    <= 64, fp32."""
    cfg = get_config(name)
    if cfg.arch_type == "unet":
        return SMOKE_UNET
    if cfg.arch_type != "decoder" or cfg.moe is not None \
            or cfg.mla is not None:
        raise NotImplementedError(
            f"{name!r} needs a layer kind the port has not ported yet "
            f"(ROADMAP A.13)")
    d_model = min(cfg.d_model, 256)
    num_heads = max(2, min(4, cfg.num_heads))
    # MQA stays MQA, MHA stays MHA, GQA halves
    if cfg.num_kv_heads == 1:
        num_kv = 1
    elif cfg.num_kv_heads == cfg.num_heads:
        num_kv = num_heads
    else:
        num_kv = max(1, num_heads // 2)
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=max(2, len(cfg.layer_pattern)),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 512,
        vocab_size=min(cfg.vocab_size, 1024),
        lru_width=d_model,
        sliding_window=min(cfg.sliding_window, 64),
        max_seq_len=1024,
        dtype="float32",
        param_dtype="float32",
    )


__all__ = ["ARCHS", "ALL_CONFIGS", "CELEBA_UNET", "CIFAR10_UNET",
           "SMOKE_UNET", "UNETS", "FLConfig", "ModelConfig", "get_config",
           "register_config", "smoke_variant"]
