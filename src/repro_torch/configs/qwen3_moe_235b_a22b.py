"""qwen3-moe-235b-a22b — MoE decoder, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B family, scaled] 94 layers, d_model=4096, 64
heads GQA kv=4, per-expert d_ff=1536, vocab 151936, 128 routed experts
top-8, no shared expert, all layers MoE.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="decoder",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                   # unused (no dense layers)
    vocab_size=151936,
    layer_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(
        num_experts=128,
        experts_per_token=8,
        d_expert=1536,
        num_shared_experts=0,
        d_shared=0,
        router_aux_loss=0.001,
        capacity_factor=1.25,
        first_dense_layers=0,
    ),
    rope_theta=1e6,
    activation="silu",
    glu=True,
    norm_eps=1e-6,
    max_seq_len=32768,
)
