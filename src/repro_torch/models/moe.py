"""Mixture-of-experts FFN with capacity-based dispatch
(``repro/models/moe.py``).

Each token picks its top-k experts from an fp32 router; the (token,
choice) pairs, in token-major order, take the next free slot of their
expert's buffer of ``capacity`` rows, and a pair past capacity is
dropped.  The kept pairs are written into a flat (E * cap + 1, d)
buffer: their (expert, slot) rows are unique, so no accumulation and no
write order decides a value, and every dropped pair goes to the one
extra row past the experts', which is never read.  The reference
instead adds each dropped pair's zeroed contribution into slot
``cap - 1``; both leave the (E, cap, d) buffer the experts see equal.
The batched expert GEMMs run over that buffer, the outputs are gathered
back per pair, weighted and summed over the k choices, and the shared
experts come last.  The expert products are plain ``bmm``, as the
reference leaves its ``einsum`` to XLA outside any kernel.

``apply_moe.dropped`` counts the pairs dropped since it was last set to
0 (a device tensor once a layer ran: reading it waits for the device).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import activation_fn, dense_init, normal
from repro_torch.models.ffn import apply_ffn, init_ffn


def init_moe(generator: torch.Generator, d_model: int, moe: MoEConfig, *,
             dtype=torch.float32, device="cpu"):
    """The router is drawn and kept in fp32 whatever ``dtype`` is."""
    E, de = moe.num_experts, moe.d_expert
    std = 1.0 / d_model ** 0.5
    p = {"router": dense_init(generator, d_model, E, torch.float32,
                              device=device),
         "w_gate": normal(generator, (E, d_model, de), std, dtype, device),
         "w_in": normal(generator, (E, d_model, de), std, dtype, device),
         "w_out": normal(generator, (E, de, d_model), de ** -0.5, dtype,
                         device)}
    if moe.num_shared_experts > 0:
        p["shared"] = init_ffn(generator, d_model, moe.d_shared, glu=True,
                               bias=False, dtype=dtype, device=device)
    return p


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, k), ids (T, k), probs (T, E)): the
    top k of the fp32 softmax, renormalized."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-9)
    return weights, ids, probs


def load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e, with f_e the share of
    the (token, choice) pairs routed to e and P_e its mean probability."""
    T, k = ids.shape
    # index_add_, not bincount: bincount reads its input's max back to
    # the host on a CUDA tensor, a sync in every MoE layer
    flat = ids.reshape(-1)
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=ids.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=ids.device))
    f = counts / (T * k)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def capacity(T: int, k: int, num_experts: int, factor: float) -> int:
    c = int(T * k * factor / num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def dispatch_indices(ids: torch.Tensor, num_experts: int, cap: int):
    """Position in its expert's buffer of each (token, choice) pair,
    counted over the pairs in token-major order.

    ids (T, k) int.  Returns pos (T, k) int64 and keep (T, k) bool
    (False: dropped, past capacity)."""
    T, k = ids.shape
    flat = ids.reshape(-1).long()
    # the one-hot expert-major, (E, T k), so that the running count is a
    # scan along contiguous rows: along the outer axis of a (T k, E)
    # one-hot CUDA's scan runs E-wide (630 ms a moonshot prefill on an
    # H100); built by comparison, since F.one_hot checks its input's
    # range on the host
    onehot = (torch.arange(num_experts, device=ids.device)[:, None]
              == flat[None, :]).long()
    before = torch.cumsum(onehot, dim=1) - onehot          # exclusive
    pos = before.gather(0, flat[None, :])[0]
    return pos.reshape(T, k), (pos < cap).reshape(T, k)


def apply_moe(p, x: torch.Tensor, moe: MoEConfig, *, activation: str):
    """x (B, S, d) -> (out (B, S, d), aux loss: fp32 0-d)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    k, E = moe.experts_per_token, moe.num_experts

    # an fp32 product even when the layer was cast to bf16: the
    # reference's fp32 activations promote its bf16-rounded router
    logits = xt.float() @ p["router"].float()
    weights, ids, probs = router_topk(logits, k)
    cap = capacity(T, k, E, moe.capacity_factor)
    pos, keep = dispatch_indices(ids, E, cap)
    flat_ids, flat_pos = ids.reshape(-1), pos.reshape(-1)
    flat_keep = keep.reshape(-1)

    # kept pairs to their unique rows, dropped ones to the spare row E*cap
    rows = torch.where(flat_keep, flat_ids * cap + flat_pos,
                       torch.full_like(flat_pos, E * cap))
    buf = xt.new_zeros((E * cap + 1, d)).index_copy(
        0, rows, xt.repeat_interleave(k, dim=0))
    buf = buf[:E * cap].view(E, cap, d)

    # batched expert FFN (swiglu)
    act = activation_fn(activation)
    h = torch.bmm(buf, p["w_in"])
    g = act(torch.bmm(buf, p["w_gate"]))
    out_buf = torch.bmm(g * h, p["w_out"]).reshape(E * cap, d)

    # gather (a dropped pair reads its expert's last slot, weighted 0) and
    # the weighted combine over the k choices
    gathered = out_buf[flat_ids * cap + torch.where(
        flat_keep, flat_pos, torch.full_like(flat_pos, cap - 1))]
    gathered = gathered * (weights.reshape(-1, 1)
                           * flat_keep.reshape(-1, 1)).to(xt.dtype)
    out = gathered.reshape(T, k, d).sum(dim=1)

    if moe.num_shared_experts > 0:
        out = out + apply_ffn(p["shared"], xt, activation=activation,
                              glu=True)

    apply_moe.dropped = apply_moe.dropped + (flat_keep.numel()
                                             - flat_keep.sum())
    aux = load_balance_loss(probs, ids, E) * moe.router_aux_loss
    return out.reshape(B, S, d), aux


apply_moe.dropped = 0
