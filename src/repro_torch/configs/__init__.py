"""Config registry: the paper's DDPM U-Nets, the reference's
architectures, their reduced smoke variants, the assigned input shapes with the per-shape
adaptation, and the federated-learning config."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, DECODE_32K,
                                      INPUT_SHAPES, LONG_500K, PREFILL_32K,
                                      RECURRENT, RWKV, TRAIN_4K, FLConfig,
                                      InputShape, MLAConfig, ModelConfig,
                                      MoEConfig)
from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.ddpm_unet import CELEBA_UNET, CIFAR10_UNET, SMOKE_UNET
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek_v3
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2_2b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.internvl2_76b import CONFIG as _internvl2_76b
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma_9b
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6_7b
from repro_torch.configs.whisper_base import CONFIG as _whisper_base

UNETS: Dict[str, ModelConfig] = {
    "ddpm-unet-cifar10": CIFAR10_UNET,
    "ddpm-unet-celeba": CELEBA_UNET,
    "ddpm-unet-smoke": SMOKE_UNET,
}

ARCHS: Dict[str, ModelConfig] = {
    "recurrentgemma-9b": _recurrentgemma_9b,
    "rwkv6-7b": _rwkv6_7b,
    "whisper-base": _whisper_base,
    "internlm2-20b": _internlm2_20b,
    "gemma2-2b": _gemma2_2b,
    "internvl2-76b": _internvl2_76b,
    "moonshot-v1-16b-a3b": _moonshot,
    "deepseek-v3-671b": _deepseek_v3,
    "qwen3-moe-235b-a22b": _qwen3_moe,
    "command-r-35b": _command_r,
}

ALL_CONFIGS: Dict[str, ModelConfig] = {**ARCHS, **UNETS}


def list_archs() -> List[str]:
    """The transformer architectures the port has, sorted."""
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


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The reference's per-shape adaptation: for ``long_500k`` decode, a
    model with full-attention layers (other than gemma2, whose local and
    global layers alternate) has its global layers made windowed
    (window 4096, ``+swa4096`` in its name), so that its KV cache and
    per-token cost stay bounded; natively sub-quadratic models and every
    other shape are left as they are."""
    if shape.name != "long_500k" or cfg.arch_type == "unet":
        return cfg
    if set(cfg.layer_kinds()) <= {ATTN_LOCAL, RECURRENT, RWKV}:
        return cfg
    if cfg.name == "gemma2-2b":
        return cfg
    pattern = tuple(ATTN_LOCAL if k == ATTN_GLOBAL else k
                    for k in cfg.layer_pattern)
    return cfg.replace(name=cfg.name + "+swa4096", layer_pattern=pattern,
                       sliding_window=4096,
                       max_seq_len=max(cfg.max_seq_len, shape.seq_len))


def smoke_variant(name: str) -> ModelConfig:
    """The reference's reduced variant (``repro/configs/__init__.py:
    smoke_variant``): one pattern cycle (at least 2 layers), d_model 256,
    32-wide heads, d_ff <= 512, vocab <= 1024, window <= 64, fp32; 4
    experts top-2 of width 64 (one shared expert and one dense head
    layer where the model has any), a small MLA; at most 2 encoder
    layers over at most 32 frames, and at most 8 image tokens."""
    cfg = get_config(name)
    if cfg.arch_type == "unet":
        return SMOKE_UNET
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
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 32)
        if cfg.arch_type == "encdec" else cfg.encoder_seq_len,
        num_image_tokens=min(cfg.num_image_tokens, 8),
        max_seq_len=1024,
        dtype="float32",
        param_dtype="float32",
    )


__all__ = ["ARCHS", "ALL_CONFIGS", "ATTN_GLOBAL", "ATTN_LOCAL",
           "CELEBA_UNET", "CIFAR10_UNET", "DECODE_32K", "INPUT_SHAPES",
           "LONG_500K", "PREFILL_32K", "RECURRENT", "RWKV", "SMOKE_UNET",
           "TRAIN_4K", "UNETS", "FLConfig", "InputShape", "MLAConfig",
           "ModelConfig", "MoEConfig", "adapt_for_shape", "get_config",
           "get_shape", "list_archs", "register_config", "smoke_variant"]
