"""recurrentgemma-9b: hybrid RG-LRU + local attention, 2:1.

[arXiv:2402.19427] Griffin / RecurrentGemma: repeating block of
(recurrent, recurrent, local attention). 38 layers, d_model=4096,
16 heads with MQA (kv=1) on the attention layers, d_ff=12288,
vocab 256000, sliding window 2048.
"""
from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="decoder",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=(RECURRENT, RECURRENT, ATTN_LOCAL),
    sliding_window=2048,
    lru_width=4096,
    conv1d_width=4,
    rope_theta=10000.0,
    activation="gelu",
    glu=True,
    norm_eps=1e-6,
    max_seq_len=1 << 20,   # recurrence + window: unbounded context
)
