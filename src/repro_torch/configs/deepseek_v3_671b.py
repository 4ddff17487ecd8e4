"""deepseek-v3-671b — MLA + fine-grained MoE (256 routed top-8 + 1
shared).

[arXiv:2412.19437] 61 layers, d_model=7168, 128 heads with Multi-head
Latent Attention (q_lora 1536, kv_lora 512, qk nope 128 + rope 64,
v 128), per-expert d_ff=2048, vocab 129280.  First 3 layers dense
(d_ff 18432).
"""
from repro_torch.configs.base import (ATTN_GLOBAL, MLAConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="decoder",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,            # MLA: per-head KV from the latent
    head_dim=128,
    d_ff=18432,                  # the dense layers' FFN
    vocab_size=129280,
    layer_pattern=(ATTN_GLOBAL,),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        experts_per_token=8,
        d_expert=2048,
        num_shared_experts=1,
        d_shared=2048,
        router_aux_loss=0.0001,
        capacity_factor=1.25,
        first_dense_layers=3,
    ),
    rope_theta=10000.0,
    activation="silu",
    glu=True,
    norm_eps=1e-6,
    max_seq_len=131072,
)
