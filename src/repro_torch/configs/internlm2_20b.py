"""internlm2-20b — dense GQA decoder.

[arXiv:2403.17297] 48 layers, d_model=6144, 48 heads, GQA kv=8,
d_ff=16384, vocab 92544, SwiGLU, RoPE theta 1e6.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    arch_type="decoder",
    source="arXiv:2403.17297",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    layer_pattern=(ATTN_GLOBAL,),
    rope_theta=1e6,
    activation="silu",
    glu=True,
    norm_eps=1e-5,
    max_seq_len=32768,
)
