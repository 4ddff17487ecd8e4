"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32 layers, d_model=4096, head_size 64 (64 heads),
channel-mix d_ff=14336, vocab 65536.  Decode is O(1)-state; long_500k
runs natively.
"""
from repro_torch.configs.base import RWKV, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="decoder",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=64,                # wkv heads: d_model / head_size(64)
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=(RWKV,),
    activation="relu",           # channel-mix uses squared ReLU
    glu=False,
    norm_eps=1e-5,
    max_seq_len=1 << 20,
)
