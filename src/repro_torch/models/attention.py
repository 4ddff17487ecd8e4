"""Grouped-query attention in plain tensor ops: dense, chunked, windowed,
cached (``repro/models/attention.py``).

Shapes (batch-major, seq-second):
  q: (B, Sq, Hq, hd)   k/v: (B, Skv, Hkv, hd)   with Hq = G * Hkv.

The decoder's decode step attends through :func:`attend` against its
ring-buffer caches, as the reference's does; its prefill goes through
the attention kernel instead (``models/ops.py:attention``), as the
reference's Pallas route does.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import softcap as _softcap

NEG_INF = -1e30


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """Additive fp32 bias from positions: 1-D positions give a batch-free
    (Sq, Skv) bias, 2-D (B, S) ones (decode ring buffers) (B, Sq, Skv)."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    zero = torch.zeros((), dtype=torch.float32, device=d.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _attend_block(q, k, v, q_pos, kv_pos, *, causal, window, attn_softcap,
                  scale):
    """Dense attention for one q block.  q (B, Sq, Hkv, G, hd), k/v
    (B, Skv, Hkv, hd).  Logits in the activation dtype, the max and the
    denominator's sum in fp32, as the reference computes them."""
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q, k) \
        * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if attn_softcap > 0.0:
        logits = _softcap(logits, attn_softcap)
    bias = _mask_bias(q_pos, kv_pos, causal=causal,
                      window=window).to(logits.dtype)
    if bias.dim() == 2:
        logits = logits + bias[None, None, None, :, :]
    else:
        logits = logits + bias[:, None, None, :, :]
    lmax = logits.float().amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - lmax.to(logits.dtype))
    denom = unnorm.float().sum(dim=-1, keepdim=True).to(logits.dtype)
    probs = unnorm / denom
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def attend(q, k, v, *, q_positions, kv_positions, causal: bool = True,
           window: int = 0, attn_softcap: float = 0.0,
           chunk: int = 0) -> torch.Tensor:
    """Generic GQA attention.

    q_positions: (Sq,) shared across the batch, or (B, Sq) int32;
    kv_positions: (Skv,) or (B, Skv).  ``chunk`` is the q-block size of
    the blocked path (0, or not dividing Sq, or >= Sq: dense); windowed
    causal blocks then read only the KV span their window reaches.
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    hd_v = v.shape[-1]
    G = Hq // Hkv
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, hd)
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap,
              scale=scale)

    if chunk <= 0 or Sq <= chunk or Sq % chunk != 0:
        out = _attend_block(qg, k, v, q_positions, kv_positions, **kw)
        return out.reshape(B, Sq, Hq, hd_v)

    if q_positions.dim() != 1 or kv_positions.dim() != 1:
        raise ValueError("chunked attention expects shared (1-D) positions")
    Skv = k.shape[1]
    kv_span = 0
    if window > 0 and causal:
        kv_span = min(Skv, -(-(window + chunk) // chunk) * chunk)
    outs = []
    for idx in range(Sq // chunk):
        qi = qg[:, idx * chunk:(idx + 1) * chunk]
        pi = q_positions[idx * chunk:(idx + 1) * chunk]
        ks, vs, kp = k, v, kv_positions
        if kv_span and kv_span < Skv:
            start = min(max((idx + 1) * chunk - kv_span, 0), Skv - kv_span)
            ks = k[:, start:start + kv_span]
            vs = v[:, start:start + kv_span]
            kp = kv_positions[start:start + kv_span]
        outs.append(_attend_block(qi, ks, vs, pi, kp, **kw))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, hd_v)


def decode_attend(q, k_cache, v_cache, pos, *, window: int = 0,
                  attn_softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode attention against a (B, S, Hkv, hd) cache.
    pos (B,) int32 is the new token's index; entries past it are
    invalid."""
    B, S = k_cache.shape[:2]
    kv_positions = torch.arange(S, dtype=torch.int32,
                                device=k_cache.device)[None].expand(B, S)
    return attend(q, k_cache, v_cache, q_positions=pos[:, None],
                  kv_positions=kv_positions, causal=True, window=window,
                  attn_softcap=attn_softcap, chunk=0)
