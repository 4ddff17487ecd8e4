"""RWKV-6 (Finch) block: time-mix with data-dependent decay and
channel-mix (``repro/models/rwkv6.py``).

Attention-free: a full sequence runs the WKV linear recurrence over
time, state (B, H, K, V) per layer, through the hand-written kernel and
trains through its backward kernel
(:class:`repro_torch.kernels.wkv6.ops.WKV6`), where the reference runs
and differentiates a ``lax.scan``; decode is the same kernel at one
token, writing the state in place.  ``wkv_chunk`` (the reference's
``ApplyOptions.wkv_chunk``) takes the chunk-parallel form instead, in
plain tensor ops as the reference computes it.  Token shift is RWKV's
ddlerp (LoRA-modulated interpolation with the previous token).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6.ops import WKV6, wkv6
from repro_torch.models.common import dense_init, normal

_LORA_R = 32
_DECAY_R = 64
_MIX = 5  # r, k, v, w, g
_LOG_CLAMP = 25.0


def _uniform(generator, shape, lo, hi, device):
    # in place, as everywhere in these initializers: the same values, and
    # on the meta device no arithmetic decomposition to load
    return torch.rand(shape, generator=generator,
                      device=device).mul_(hi - lo).add_(lo)


def init_rwkv_tmix(generator: torch.Generator, d_model: int, num_heads: int,
                   head_dim: int, dtype=torch.float32, device="cpu"):
    """The reference's time-mix params, its distributions and scales;
    ``w0`` and ``u`` fp32 whatever ``dtype``."""
    d, dh = d_model, num_heads * head_dim

    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    return {
        "mu_base": _uniform(generator, (d,), 0, 1, device).mul_(0.5).to(dtype),
        "mu": _uniform(generator, (_MIX, d), 0, 1, device).mul_(0.5).to(dtype),
        "lora_a": normal(generator, (_MIX, d, _LORA_R), 0.01, dtype, device),
        "lora_b": normal(generator, (_MIX, _LORA_R, d), 0.01, dtype, device),
        "w0": _uniform(generator, (dh,), -7.0, -4.0, device),
        "decay_a": normal(generator, (d, _DECAY_R), 0.01, dtype, device),
        "decay_b": normal(generator, (_DECAY_R, dh), 0.01, dtype, device),
        "u": normal(generator, (num_heads, head_dim), 0.1, torch.float32,
                    device),
        "w_r": dense(d, dh),
        "w_k": dense(d, dh),
        "w_v": dense(d, dh),
        "w_g": dense(d, dh),
        "w_o": dense(dh, d),
        "ln_scale": torch.ones((dh,), dtype=dtype, device=device),
    }


def init_rwkv_cmix(generator: torch.Generator, d_model: int, d_ff: int,
                   dtype=torch.float32, device="cpu"):
    def dense(i, o):
        return dense_init(generator, i, o, dtype, device=device)

    return {
        "mu_k": _uniform(generator, (d_model,), 0, 1, device).mul_(0.5
                                                                    ).to(dtype),
        "mu_r": _uniform(generator, (d_model,), 0, 1, device).mul_(0.5
                                                                    ).to(dtype),
        "w_k": dense(d_model, d_ff),
        "w_v": dense(d_ff, d_model),
        "w_r": dense(d_model, d_model),
    }


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token-shift interpolation -> the (r, k, v, w, g)
    inputs, (5, B, S, d)."""
    dx = x_prev - x
    xx = x + dx * p["mu_base"]
    # two-step LoRA: tanh(xx @ A_m) @ B_m per mix channel m
    t = torch.tanh(torch.einsum("bsd,mdr->mbsr", xx, p["lora_a"]))
    delta = torch.einsum("mbsr,mrd->mbsd", t, p["lora_b"])
    return x[None] + dx[None] * (p["mu"][:, None, None, :] + delta)


def wkv_chunked(r, k, v, w, u, state, chunk: int):
    """The reference's chunk-parallel WKV (``_wkv_chunked``, the
    flash-linear-attention form) in plain tensor ops: within a chunk of
    L steps (1-based t, C_t = prod_{s<=t} w_s)

      y_t   = (r_t . C_{t-1}) @ S_0
              + sum_{s<t} [(r_t . C_{t-1}) @ (k_s / C_s)] v_s
              + (r_t . u . k_t) v_t
      S_out = diag(C_L) (S_0 + sum_s (k_s / C_s) v_s^T)

    with the log-cumulative decays clamped at +-25 (contributions past
    e^-25 dropped), so it differs from the exact recurrence where decays
    are that strong.  S must be a multiple of ``chunk``.  Returns
    (state, out)."""
    S = k.shape[1]
    S0 = state.float()
    tri = torch.tril(torch.ones((chunk, chunk), device=k.device), -1)
    eye = torch.eye(chunk, device=k.device)
    ys = []
    for i in range(0, S, chunk):
        rc, kc, vc = (x[:, i:i + chunk].float() for x in (r, k, v))
        wc = w[:, i:i + chunk]                      # (B, chunk, H, K)
        lw = torch.log(torch.clamp(wc, min=1e-38))  # <= 0
        cum = torch.cumsum(lw, dim=1)               # C_t in log space
        cum_prev = cum - lw                         # C_{t-1}
        r_t = rc * torch.exp(torch.clamp(cum_prev, min=-_LOG_CLAMP))
        k_t = kc * torch.exp(torch.clamp(-cum, max=_LOG_CLAMP))
        A = torch.einsum("bthk,bshk->bhts", r_t, k_t)           # (B,H,c,c)
        diag = torch.einsum("bthk,bthk->bht", rc * u[None, None], kc)
        A = A * tri + diag[..., None] * eye
        y = torch.einsum("bhts,bshv->bthv", A, vc)              # intra-chunk
        y = y + torch.einsum("bthk,bhkv->bthv", r_t, S0)        # state term
        kv = torch.einsum("bshk,bshv->bhkv", k_t, vc)
        S0 = torch.exp(torch.clamp(cum[:, -1], min=-_LOG_CLAMP)
                       )[..., None] * (S0 + kv)
        ys.append(y)
    return S0, torch.cat(ys, dim=1)


def _shifted(x: torch.Tensor, state, key: str) -> torch.Tensor:
    """x's previous token at each position: the state's ``key`` row
    (zeros without a state) before the first."""
    B, S, d = x.shape
    first = state[key][:, None, :] if state is not None \
        else x.new_zeros((B, 1, d))
    return torch.cat([first, x[:, :-1]], dim=1)


def apply_tmix(p, x: torch.Tensor, num_heads: int, head_dim: int, *,
               state=None, wkv_chunk: int = 0, inplace: bool = False):
    """Time-mix over a sequence.  x (B, S, d); ``state`` optional
    {"S": (B, H, K, V) fp32, "shift": (B, d)} to continue from.
    Returns (out (B, S, d), new state).  The exact route runs the WKV
    kernel; ``wkv_chunk`` > 0 with S a multiple of it and S > wkv_chunk
    the chunked form, as the reference decides.  ``inplace`` (with a
    state): the new state is written into ``state``'s tensors (the
    decode step)."""
    B, S, _ = x.shape
    H, K = num_heads, head_dim
    mixed = _ddlerp(p, x, _shifted(x, state, "shift"))
    lr, lk, lv, lw, lg = mixed.unbind(0)

    r = (lr @ p["w_r"]).reshape(B, S, H, K)
    k = (lk @ p["w_k"]).reshape(B, S, H, K)
    v = (lv @ p["w_v"]).reshape(B, S, H, K)
    g = F.silu(lg @ p["w_g"])
    decay = p["w0"].float() + (torch.tanh(lw @ p["decay_a"])
                               @ p["decay_b"]).float()
    w = torch.exp(-torch.exp(decay)).reshape(B, S, H, K)
    u = p["u"].float()

    S0 = state["S"] if state is not None else torch.zeros(
        (B, H, K, K), dtype=torch.float32, device=x.device)
    if wkv_chunk and S % wkv_chunk == 0 and S > wkv_chunk:
        S_new, wkv = wkv_chunked(r, k, v, w, u, S0, wkv_chunk)
        if inplace:
            state["S"].copy_(S_new)
    elif inplace:
        wkv, S_new = wkv6(r.float().contiguous(), k.float().contiguous(),
                          v.float().contiguous(), w.contiguous(), u, S0,
                          inplace=True)
    else:
        wkv, S_new = WKV6.apply(r.float().contiguous(),
                                k.float().contiguous(),
                                v.float().contiguous(), w.contiguous(), u,
                                S0.contiguous())

    # per-head group norm, the population variance
    var, mu = torch.var_mean(wkv, dim=-1, keepdim=True, correction=0)
    wkv = (wkv - mu) * torch.rsqrt(var + 1e-5)
    out = (wkv.reshape(B, S, H * K).to(x.dtype) * p["ln_scale"]) * g
    if inplace:
        state["shift"].copy_(x[:, -1, :])
        return out @ p["w_o"], state
    return out @ p["w_o"], {"S": S_new, "shift": x[:, -1, :]}


def apply_cmix(p, x: torch.Tensor, *, state=None, inplace: bool = False):
    """Channel-mix.  x (B, S, d); ``state`` {"shift": (B, d)}, written in
    place with ``inplace``."""
    dx = _shifted(x, state, "shift") - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["w_k"]))
    out = torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"])
    if inplace:
        state["shift"].copy_(x[:, -1, :])
        return out, state
    return out, {"shift": x[:, -1, :]}


def init_rwkv_state(batch: int, d_model: int, num_heads: int, head_dim: int,
                    dtype, device="cpu"):
    return {
        "S": torch.zeros((batch, num_heads, head_dim, head_dim),
                         dtype=torch.float32, device=device),
        "shift_t": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }
