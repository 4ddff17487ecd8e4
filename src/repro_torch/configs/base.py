"""Model and federated-learning configuration, the port's own copy of
``repro.configs.base``.

:class:`ModelConfig` keeps every field of the reference, so a ``cfg``
dict written into a checkpoint manifest by either package round-trips
through :func:`config_from_dict` unchanged.  The U-Net reads the U-Net
fields and the transformer stack the rest.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# layer kinds of the decoder stack, as the reference numbers them
ATTN_GLOBAL = 0      # full causal attention
ATTN_LOCAL = 1       # sliding-window causal attention
RECURRENT = 2        # RG-LRU recurrent block (RecurrentGemma)
RWKV = 3             # RWKV6 time-mix and channel-mix block


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_expert: int
    num_shared_experts: int = 0
    d_shared: int = 0
    router_aux_loss: float = 0.0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    """Unified model configuration: ``arch_type`` "unet" (the paper's
    DDPM U-Net), "decoder" (the causal LM stack), "encdec" (whisper's
    encoder and a decoder with cross-attention; the audio frontend is a
    stub) or "vlm" (image embeddings before the text; the vision
    frontend is a stub)."""
    name: str
    arch_type: str
    source: str = ""

    # --- transformer backbone ----------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    max_seq_len: int = 8192
    layer_pattern: Tuple[int, ...] = (ATTN_GLOBAL,)
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    use_qkv_bias: bool = False
    use_attn_out_bias: bool = False
    use_ffn_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    activation: str = "silu"
    glu: bool = True
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    parallel_block: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    lru_width: int = 0
    conv1d_width: int = 4
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500
    num_image_tokens: int = 0
    # --- unet ----------------------------------------------------------------
    image_size: int = 32
    in_channels: int = 3
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    num_classes: int = 0
    dropout: float = 0.1
    diffusion_steps: int = 1000
    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # the reference's compute-backend name; the port dispatches on the
    # tensor's device instead and never reads it
    backend: str = ""
    # "fp32" | "bf16"; "" resolves via $FEDPHD_PRECISION
    precision: str = ""

    def __post_init__(self):
        if self.arch_type != "unet":
            if self.head_dim == 0 and self.num_heads:
                object.__setattr__(self, "head_dim",
                                   self.d_model // self.num_heads)
            if self.num_kv_heads == 0:
                object.__setattr__(self, "num_kv_heads", self.num_heads)
            if self.lru_width == 0:
                object.__setattr__(self, "lru_width", self.d_model)

    def layer_kinds(self) -> Tuple[int, ...]:
        """Per-layer kind, the pattern cycled to ``num_layers``."""
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_per_kv(self) -> int:
        """Query heads per KV head (G of GQA)."""
        return max(1, self.num_heads // max(1, self.num_kv_heads))


@dataclass(frozen=True)
class InputShape:
    """One assigned (global) input shape (``repro/configs/base.py``)."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                            # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")
INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}


_MODEL_TUPLE_FIELDS = ("layer_pattern", "channel_mults", "attn_resolutions")


def config_to_dict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ModelConfig:
    """Inverse of :func:`config_to_dict`; JSON turned the tuples into
    lists, so they are coerced back."""
    d = dict(d)
    if d.get("moe"):
        d["moe"] = MoEConfig(**d["moe"])
    if d.get("mla"):
        d["mla"] = MLAConfig(**d["mla"])
    for k in _MODEL_TUPLE_FIELDS:
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return ModelConfig(**d)


def fl_to_dict(fl: "FLConfig") -> dict:
    return dataclasses.asdict(fl)


def fl_from_dict(d: dict) -> "FLConfig":
    return FLConfig(**d)


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning / FedPhD hyper-parameters (paper §V-A) and the
    flat baselines' knobs (``fedprox_mu``, ``moon_mu``, ``moon_tau``,
    read by :mod:`repro_torch.fl.client`).  ``seed`` is carried so that a
    spec of either package round-trips key for key; no trainer reads it
    (a trainer's seed is its ``rng_seed``, which the experiment API sets
    from ``ExperimentSpec.seed``)."""
    num_clients: int = 20                # N
    num_edges: int = 2                   # N_e
    participation: float = 1.0           # kappa
    local_epochs: int = 1                # E
    edge_agg_every: int = 1              # r_e
    cloud_agg_every: int = 5             # r_g
    rounds: int = 100                    # R
    sparse_rounds: int = 20              # R_s
    # SH-score weighting (eqs 22/24/25)
    sh_a: float = 15000.0
    sh_b: float = 0.0
    # pruning
    prune_ratio: float = 0.44            # s_p
    prune_mode: str = "group_norm"       # "group_norm" | "oneshot_random" | "oneshot_l2"
    lambda0: float = 1e-4                # group-lasso base scale (eq 17)
    # baseline knobs
    fedprox_mu: float = 1.0
    moon_mu: float = 1.0
    moon_tau: float = 0.5
    seed: int = 0
