"""RWKV-6's WKV recurrence: r, k, w (B, S, H, K), v (B, S, H, V), the
bonus u (H, K) and a (B, H, K, V) state S_{-1}; for each batch row and
head, in fp32,

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

and the result is (out (B, S, H, V), S_{S-1}).

No TPU kernel computes it: the reference runs the recurrence as the
``lax.scan`` of ``repro/models/rwkv6.py:67 _wkv_scan``, and
differentiates that scan.  In PyTorch the same loop would be ~10 small
launches a token and layer, and its autograd would keep a (K, V) state
a token; so the port runs it in ``csrc/wkv6.cu`` (the source says what
bounds it on the H100 and how the design answers that), forward and
backward.  The kernel takes K = V in :data:`HEAD_SIZES` and fp32
tensors, as the reference's scan computes in fp32.

:func:`wkv6` dispatches on the tensor's device: a CUDA tensor launches
the kernel (counted in ``wkv6.launches``, and by shape in
``wkv6.shapes``), a CPU tensor runs :func:`wkv6_plain`.  The decode
step is the same launch at S = 1 with ``inplace=True``: the new state
is written over the given one.  :func:`wkv6_backward` gives the six
gradients (r, k, v, w, u and the initial state) from the output's and
the final state's: the source's backward kernels on a CUDA tensor
(``wkv6.bwd_launches``, ``wkv6.bwd_shapes``), :func:`wkv6_backward_plain`
on a CPU tensor.  :class:`WKV6` is the differentiable recurrence that
``models/rwkv6.py`` trains through.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build

HEAD_SIZES = (32, 64)
CHUNK = 8          # the source's CH: steps a backward chunk and checkpoint


def wkv6_plain(r, k, v, w, u, state):
    """The plain PyTorch version: the reference's ``_wkv_scan`` step for
    step (kv = k v^T, out = r^T (S + u kv), S = w S + kv) in fp32.
    Returns (out (B, S, H, V), new state (B, H, K, V))."""
    st = state.float()
    uu = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None].float() * v[:, t, :, None, :].float()
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                                 st + uu * kv))
        st = w[:, t, :, :, None].float() * st + kv
    return torch.stack(outs, dim=1), st


def wkv6_backward_plain(r, k, v, w, u, state, dout, dstate):
    """The backward's plain version in fp32, from the states before each
    step (the forward replayed and kept) and the adjoint
    G_{t-1} = diag(w_t) G_t + r_t dout_t^T, G_{S-1} = dstate:

      dr_t = S_{t-1} dout_t + u . k_t (v_t . dout_t)
      dk_t = G_t v_t + u . r_t (v_t . dout_t)
      dv_t = G_t^T k_t + dout_t (r_t . u . k_t)
      dw_t = rowsum(G_t . S_{t-1})
      du   = sum_t r_t . k_t (v_t . dout_t), over the batch too

    and the state's gradient G_{-1}.  Returns (dr, dk, dv, dw, du,
    dstate0)."""
    f = [x.float() for x in (r, k, v, w, dout)]
    r, k, v, w, dout = f
    uu = u.float()
    states, st = [], state.float()
    for t in range(r.shape[1]):
        states.append(st)
        st = w[:, t, :, :, None] * st + k[:, t, :, :, None] \
            * v[:, t, :, None, :]
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.zeros_like(uu)
    g = dstate.float()
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dot = r[:, t], k[:, t], v[:, t], w[:, t], dout[:, t]
        vd = (vt * dot).sum(-1, keepdim=True)                   # (B, H, 1)
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", states[t], dot) \
            + uu * kt * vd
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", g, vt) + uu * rt * vd
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", g, kt) \
            + dot * (rt * uu * kt).sum(-1, keepdim=True)
        dw[:, t] = (g * states[t]).sum(-1)
        du = du + (rt * kt * vd).sum(0)
        g = wt[..., None] * g + rt[..., None] * dot[..., None, :]
    return dr, dk, dv, dw, du, g


def _check(r, k, v, w, u, state):
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"shapes r{tuple(r.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} w{tuple(w.shape)} are not "
                         f"(B, S, H, K) and (B, S, H, V)")
    B, S, H, K = r.shape
    if S < 1:
        raise ValueError("wkv6 needs at least one step")
    if u.shape != (H, K) or state.shape != (B, H, K, v.shape[-1]):
        raise ValueError(f"u{tuple(u.shape)} or state{tuple(state.shape)} "
                         f"is not (H, K) or (B, H, K, V)")


def _check_cuda(tensors, what: str):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: the kernel takes float32 tensors, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if not all(t.is_contiguous() and t.device == dev
               and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous, 16-byte "
                         f"aligned and on one device (rows arrive by "
                         f"16-byte copies)")


def _check_sizes(r, v, what: str):
    B, S, H, K = r.shape
    if v.shape[-1] != K or K not in HEAD_SIZES:
        raise ValueError(f"{what}: K = {K}, V = {v.shape[-1]}: the kernel "
                         f"takes K = V in {HEAD_SIZES}")
    if B * H > 2 ** 31 - 1 or B * S * H * K > 2 ** 31 - 1:
        raise ValueError(f"{what}: (B, S, H, K) = {tuple(r.shape)} is past "
                         f"the kernel's 32-bit offsets")


def wkv6(r, k, v, w, u, state, *, inplace: bool = False):
    """(out (B, S, H, V), new state (B, H, K, V)) of the recurrence from
    ``state``.  ``inplace``: the new state is written into ``state``,
    which is returned (the decode step)."""
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        out, new = wkv6_plain(r, k, v, w, u, state)
        if inplace:
            state.copy_(new)
            new = state
        return out, new
    _check_cuda((r, k, v, w, u, state), "wkv6")
    _check_sizes(r, v, "wkv6")
    B, S, H, K = r.shape
    out = torch.empty_like(v)
    new = state if inplace else torch.empty_like(state)
    err = build.library().wkv6_fwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), state.data_ptr(), out.data_ptr(), new.data_ptr(),
        B, S, H, K, build.stream_handle(r.device))
    build.check(err, "wkv6")
    wkv6.launches += 1
    wkv6.shapes[(B, S, H, K, "float32")] += 1
    return out, new


def wkv6_backward(r, k, v, w, u, state, dout, dstate):
    """(dr, dk, dv, dw, du, dstate0) of :func:`wkv6` for the output's
    gradient ``dout`` (B, S, H, V) and the new state's ``dstate``."""
    _check(r, k, v, w, u, state)
    if dout.shape != v.shape or dstate.shape != state.shape:
        raise ValueError(f"dout{tuple(dout.shape)} or "
                         f"dstate{tuple(dstate.shape)} does not match the "
                         f"forward's out and state")
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, state, dout, dstate)
    _check_cuda((r, k, v, w, u, state, dout, dstate), "wkv6_backward")
    _check_sizes(r, v, "wkv6_backward")
    B, S, H, K = r.shape
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du_rows = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(state)
    chunks = -(-S // CHUNK)
    # the state before each chunk, from the forward-in-time pass
    ckpt = torch.empty((B * H, chunks, K, K), dtype=torch.float32,
                       device=r.device)
    err = build.library().wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), dout.data_ptr(), dstate.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_rows.data_ptr(),
        ds0.data_ptr(), ckpt.data_ptr(), B, S, H, K, CHUNK,
        build.stream_handle(r.device))
    build.check(err, "wkv6_backward")
    wkv6.bwd_launches += 1
    wkv6.bwd_shapes[(B, S, H, K, "float32")] += 1
    # du's batch rows summed outside the kernel: blocks do not share sums
    return dr, dk, dv, dw, du_rows.sum(0), ds0


class WKV6(torch.autograd.Function):
    """Differentiable :func:`wkv6`: (out, new state) from (r, k, v, w,
    u, state), all fp32; the backward is :func:`wkv6_backward`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        out, new = wkv6(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return out, new

    @staticmethod
    def backward(ctx, dout, dstate):
        return wkv6_backward(*ctx.saved_tensors, dout.contiguous(),
                             dstate.contiguous())


wkv6.launches = 0
wkv6.shapes = Counter()              # (B, S, H, K, dtype) -> launches
wkv6.bwd_launches = 0
wkv6.bwd_shapes = Counter()          # (B, S, H, K, dtype) -> launches
