"""command-r-35b — dense GQA decoder, no biases, parallel block.

[hf:CohereForAI/c4ai-command-r-v01] 40 layers, d_model=8192, 64 heads,
GQA kv=8 (the reference's setting), d_ff=22528, vocab 256000, parallel
attention+FFN block, tied embeddings, no bias anywhere.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="decoder",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    layer_pattern=(ATTN_GLOBAL,),
    parallel_block=True,
    tie_embeddings=True,
    rope_theta=8e6,
    activation="silu",
    glu=True,
    norm_eps=1e-5,
    max_seq_len=131072,
)
