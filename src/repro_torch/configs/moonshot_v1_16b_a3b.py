"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — fine-grained MoE decoder.

[hf:moonshotai/Moonlight-16B-A3B] DeepSeek-V2-lite-style: 48 layers,
d_model=2048, 16 heads MHA (kv=16), per-expert d_ff=1408, vocab 163840,
64 routed experts top-6 + 2 shared experts, first layer dense.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="decoder",
    source="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,                  # the dense (first) layer's FFN
    vocab_size=163840,
    layer_pattern=(ATTN_GLOBAL,),
    moe=MoEConfig(
        num_experts=64,
        experts_per_token=6,
        d_expert=1408,
        num_shared_experts=2,
        d_shared=2816,
        router_aux_loss=0.001,
        capacity_factor=1.25,
        first_dense_layers=1,
    ),
    rope_theta=5e4,
    activation="silu",
    glu=True,
    norm_eps=1e-5,
    max_seq_len=32768,
)
