"""DeepSeek-V3 Multi-head Latent Attention (``repro/models/mla.py``).

Train and prefill rebuild per-head K and V from the shared KV latent
and attend with :func:`repro_torch.models.attention.attend`, as the
reference does (its qk width 192 and v width 128 differ, which the
attention kernel does not take; the reference's Pallas route does not
take it either).  Decode uses the matrix-absorbed form: the cache holds
only the latent ``c`` (kv_lora_rank) and the shared RoPE key ``kr``,
whatever the number of heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.attention import NEG_INF, attend
from repro_torch.models.common import apply_rope, dense_init, rms_norm


def init_mla(generator: torch.Generator, d_model: int, num_heads: int,
             mla: MLAConfig, dtype=torch.float32, device="cpu"):
    H = num_heads
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim

    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {"wq_a": dense(d_model, mla.q_lora_rank),
            "q_norm": zeros(mla.q_lora_rank),
            "wq_b": dense(mla.q_lora_rank, H * qk),
            "wkv_a": dense(d_model, mla.kv_lora_rank + mla.qk_rope_head_dim),
            "kv_norm": zeros(mla.kv_lora_rank),
            "wkv_b": dense(mla.kv_lora_rank,
                           H * (mla.qk_nope_head_dim + mla.v_head_dim)),
            "wo": dense(H * mla.v_head_dim, d_model)}


def _project_q(p, x: torch.Tensor, mla: MLAConfig, num_heads: int,
               positions: torch.Tensor, rope_theta: float):
    B, S, _ = x.shape
    qk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    q = rms_norm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(B, S, num_heads, qk)
    q_nope = q[..., :mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def _latent_kv(p, x: torch.Tensor, mla: MLAConfig, positions: torch.Tensor,
               rope_theta: float):
    kv_a = x @ p["wkv_a"]
    c_kv = rms_norm(kv_a[..., :mla.kv_lora_rank], p["kv_norm"])
    k_rope = kv_a[..., mla.kv_lora_rank:][:, :, None, :]     # (B, S, 1, rope)
    k_rope = apply_rope(k_rope, positions, rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def apply_mla(p, x: torch.Tensor, mla: MLAConfig, num_heads: int,
              positions: torch.Tensor, *, rope_theta: float, chunk: int = 0,
              window: int = 0) -> torch.Tensor:
    """Full-sequence MLA (train / prefill).  x (B, S, d)."""
    B, S, _ = x.shape
    H = num_heads
    q_nope, q_rope = _project_q(p, x, mla, H, positions, rope_theta)
    c_kv, k_rope = _latent_kv(p, x, mla, positions, rope_theta)

    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, mla.qk_nope_head_dim
                                     + mla.v_head_dim)
    k_nope = kv[..., :mla.qk_nope_head_dim]
    v = kv[..., mla.qk_nope_head_dim:]

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, mla.qk_rope_head_dim)], dim=-1)
    out = attend(q, k, v, q_positions=positions, kv_positions=positions,
                 causal=True, window=window, chunk=chunk)
    return out.reshape(B, S, H * mla.v_head_dim) @ p["wo"]


def mla_decode(p, x: torch.Tensor, cache_c: torch.Tensor,
               cache_kr: torch.Tensor, pos: torch.Tensor, mla: MLAConfig,
               num_heads: int, *, rope_theta: float, window: int = 0):
    """Matrix-absorbed single-token decode.

    x (B, 1, d); cache_c (B, S, L); cache_kr (B, S, rope); pos (B,).
    Writes the token's latent and RoPE key at ``pos`` of ``cache_c`` and
    ``cache_kr`` in place (the reference returns updated copies) and
    returns (out (B, 1, d), cache_c, cache_kr)."""
    B = x.shape[0]
    H, L = num_heads, mla.kv_lora_rank
    positions = pos[:, None]
    q_nope, q_rope = _project_q(p, x, mla, H, positions, rope_theta)

    c_new, kr_new = _latent_kv(p, x, mla, positions, rope_theta)
    bidx = torch.arange(B, device=x.device)
    cache_c[bidx, pos.long()] = c_new[:, 0].to(cache_c.dtype)
    cache_kr[bidx, pos.long()] = kr_new[:, 0].to(cache_kr.dtype)

    wkv_b = p["wkv_b"].reshape(L, H, mla.qk_nope_head_dim + mla.v_head_dim)
    w_uk = wkv_b[..., :mla.qk_nope_head_dim]                 # (L, H, nope)
    w_uv = wkv_b[..., mla.qk_nope_head_dim:]                 # (L, H, v)

    # W_uk absorbed into the query: q_abs (B, 1, H, L)
    q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)
    scale = (mla.qk_nope_head_dim + mla.qk_rope_head_dim) ** -0.5
    logits = (torch.einsum("bqhl,bsl->bhqs", q_abs,
                           cache_c.to(q_abs.dtype))
              + torch.einsum("bqhr,bsr->bhqs", q_rope,
                             cache_kr.to(q_rope.dtype)))
    logits = logits.float() * scale

    S = cache_c.shape[1]
    kv_pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    ok = kv_pos <= pos[:, None]
    if window > 0:
        ok &= (pos[:, None] - kv_pos) < window
    logits = torch.where(ok[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)

    lat = torch.einsum("bhqs,bsl->bqhl", probs, cache_c.to(probs.dtype))
    out = torch.einsum("bqhl,lhv->bqhv", lat, w_uv)
    out = out.reshape(B, 1, H * mla.v_head_dim) @ p["wo"]
    return out, cache_c, cache_kr
