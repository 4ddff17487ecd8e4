"""gemma2-2b — dense GQA with alternating local/global attention + softcaps.

[arXiv:2408.00118] 26 layers, d_model=2304, 8 heads GQA kv=4, head_dim=256,
d_ff=9216, vocab 256000.  Alternates sliding-window (4096) and global
attention; logit softcap 30, attention softcap 50; GeGLU FFN.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="decoder",
    source="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    sliding_window=4096,
    logit_softcap=30.0,
    attn_softcap=50.0,
    rope_theta=10000.0,
    activation="gelu",
    glu=True,
    tie_embeddings=True,
    norm_eps=1e-6,
    max_seq_len=1 << 20,
)
