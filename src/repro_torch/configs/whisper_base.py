"""whisper-base — audio encoder-decoder transformer backbone.

[arXiv:2212.04356] Whisper base: 6 encoder + 6 decoder layers, d_model=512,
8 heads (full MHA, kv=8), d_ff=2048, vocab 51865.  The mel-spectrogram +
conv frontend is a stub, as in the reference: ``input_specs()`` provides
precomputed frame embeddings of shape (batch, 1500, 512).

Positions use RoPE, as every model of the stack does, in place of
whisper's learned absolute embeddings (the reference's choice).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="encdec",
    source="arXiv:2212.04356",
    num_layers=6,              # decoder layers
    num_encoder_layers=6,
    encoder_seq_len=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    layer_pattern=(ATTN_GLOBAL,),
    activation="gelu",
    glu=False,                 # whisper uses plain GELU MLP
    use_qkv_bias=True,
    use_attn_out_bias=True,
    use_ffn_bias=True,
    norm_eps=1e-5,
    max_seq_len=32768,
)
