"""internvl2-76b — VLM: InternViT frontend (STUB) + Llama-3-70B-class LM.

[arXiv:2404.16821] Language backbone: 80 layers, d_model=8192, 64 heads
GQA kv=8, d_ff=28672, vocab 128256.  The vision encoder (InternViT-6B) and
MLP projector are stubs, as in the reference: ``input_specs()`` provides
precomputed patch embeddings (batch, num_image_tokens, d_model) that are
prepended to the token embeddings.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    num_image_tokens=256,
    layer_pattern=(ATTN_GLOBAL,),
    rope_theta=5e5,
    activation="silu",
    glu=True,
    norm_eps=1e-5,
    max_seq_len=32768,
)
