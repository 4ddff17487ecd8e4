"""Config registry: the paper's DDPM U-Nets, the decoder LMs the port
serves, their reduced smoke variants, and the federated-learning
config."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (DECODE_32K, LONG_500K, PREFILL_32K,
                                      TRAIN_4K, FLConfig, InputShape,
                                      MLAConfig, ModelConfig, MoEConfig)
from repro_torch.configs.ddpm_unet import CELEBA_UNET, CIFAR10_UNET, SMOKE_UNET
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
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
    "moonshot-v1-16b-a3b": _moonshot,
    "deepseek-v3-671b": _deepseek_v3,
    "qwen3-moe-235b-a22b": _qwen3_moe,
}

ALL_CONFIGS: Dict[str, ModelConfig] = {**ARCHS, **UNETS}


def list_archs() -> List[str]:
    """The decoder architectures the port has, sorted."""
    return sorted(ARCHS.keys())


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
    cycle (at least 2 layers), d_model 256, 32-wide heads, d_ff <= 512,
    vocab <= 1024, window <= 64, fp32; 4 experts top-2 of width 64 (one
    shared expert and one dense head layer where the model has any), and
    a small MLA."""
    cfg = get_config(name)
    if cfg.arch_type == "unet":
        return SMOKE_UNET
    if cfg.arch_type != "decoder":
        raise NotImplementedError(
            f"{name!r} is {cfg.arch_type!r}: encoder-decoder and VLM "
            f"models are not ported yet (ROADMAP A.13)")
    d_model = min(cfg.d_model, 256)
    num_heads = max(2, min(4, cfg.num_heads))
    # MQA stays MQA, MHA stays MHA, GQA halves
    if cfg.num_kv_heads == 1:
        num_kv = 1
    elif cfg.num_kv_heads == cfg.num_heads:
        num_kv = num_heads
    else:
        num_kv = max(1, num_heads // 2)
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, num_experts=4, experts_per_token=2, d_expert=64,
        num_shared_experts=min(1, cfg.moe.num_shared_experts),
        d_shared=64 if cfg.moe.num_shared_experts else 0,
        first_dense_layers=min(1, cfg.moe.first_dense_layers))
    mla = cfg.mla and MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                qk_nope_head_dim=32, qk_rope_head_dim=16,
                                v_head_dim=32)
    return cfg.replace(
        name=cfg.name + "-smoke",
        num_layers=max(2, len(cfg.layer_pattern)),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=32,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 512,
        vocab_size=min(cfg.vocab_size, 1024),
        moe=moe,
        mla=mla,
        lru_width=d_model,
        sliding_window=min(cfg.sliding_window, 64),
        max_seq_len=1024,
        dtype="float32",
        param_dtype="float32",
    )


__all__ = ["ARCHS", "ALL_CONFIGS", "CELEBA_UNET", "CIFAR10_UNET",
           "DECODE_32K", "LONG_500K", "PREFILL_32K", "SMOKE_UNET",
           "TRAIN_4K", "UNETS", "FLConfig", "InputShape", "MLAConfig",
           "ModelConfig", "MoEConfig",
           "get_config", "list_archs", "register_config", "smoke_variant"]
