"""The quantized client->edge uplink with error feedback, and the bytes on
the wire (``repro/fl/compress.py``).

FedPhD cuts communication structurally (the pruned model is smaller);
this cuts it numerically on the same uplink: an on-time client uploads
its round delta ``theta_i - start`` as int8 or fp8-e4m3 with one fp32
scale per parameter leaf, and keeps a persistent fp32 error-feedback
row, so the quantization residual is added to its next delta instead of
being lost (FedDM's compression direction, PAPERS.md).

Contract:

  * only the on-time reporting uplink is quantized.  Late (staleness)
    deltas, SCAFFOLD's control variates and every download ship
    uncompressed; MOON's and FedDiffuse's client-local state never goes
    on the wire and stays exact.
  * the edge aggregates the reconstructed ``start + deq``, what it can
    decode, so the trajectory carries the compression error.
  * error-feedback rows are per-client fp32 trees congruent with the
    params, kept in the trainers' stacked (N, ...) state, checkpointed,
    and reset at the prune (the leaf shapes change).
  * scales are per leaf per client, ``maxabs / qmax``.  int8 rounds half
    to even (``torch.round``, as ``jnp.round``); fp8 values are clipped
    to +-448 before the cast to ``torch.float8_e4m3fn``, as the
    reference must (XLA's cast makes NaN of what overflows).

Bytes on the wire (:func:`uplink_bytes`, :func:`downlink_bytes`): a
quantized payload is 1 byte an element plus a 4-byte scale a leaf; an
unquantized upload the fp32 master delta; a download the compute-dtype
cast clients train on (2 bytes a parameter under bf16).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.tree import tree_leaves, tree_unflatten

QUANTS = ("none", "int8", "fp8")
# fp8 is e4m3fn: largest finite magnitude 448; int8 symmetric about 0
_QMAX = {"int8": 127.0, "fp8": 448.0}
_PRECISION_BYTES = {"": 4, "fp32": 4, "bf16": 2}


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """The uplink's compression (on ``ExperimentSpec.comm``)."""
    quant: str = "none"          # none | int8 | fp8

    def __post_init__(self):
        if self.quant not in QUANTS:
            raise ValueError(f"comm.quant={self.quant!r} not in {QUANTS}")

    @property
    def enabled(self) -> bool:
        return self.quant != "none"

    def replace(self, **kw) -> "CommSpec":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CommSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ---------------------------------------------------------------------------
# quantize and dequantize
# ---------------------------------------------------------------------------

def _quantize_leaf(v: torch.Tensor, quant: str, stacked: bool):
    """fp32 leaf -> (payload, fp32 scale), scaled by maxabs / qmax over
    the whole leaf, or over the trailing axes of a stacked (C, ...) leaf
    (one scale a client)."""
    qmax = _QMAX[quant]
    a = v.abs()
    if not stacked:
        amax = a.amax()
    elif a.dim() > 1:
        amax = a.amax(dim=tuple(range(1, a.dim())), keepdim=True)
    else:
        amax = a                           # a stacked scalar leaf
    # qmax as a tensor of the card's: CUDA divides by a Python scalar as
    # a multiply by its reciprocal, which is not the reference's division
    scale = torch.where(amax > 0, amax / amax.new_full((), qmax),
                        torch.ones_like(amax))
    if quant == "int8":
        q = torch.clamp(torch.round(v / scale), -qmax, qmax).to(torch.int8)
    else:
        # the cast must not see what lies beyond +-448
        q = torch.clamp(v / scale, -qmax, qmax).to(torch.float8_e4m3fn)
    return q, scale


def _ef_leaf(d: torch.Tensor, e: torch.Tensor, quant: str, *,
             stacked: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    v = d.float() + e
    q, scale = _quantize_leaf(v, quant, stacked)
    deq = q.float() * scale
    return deq, v - deq


def _ef_tree(delta, err, quant: str, stacked: bool, start=None):
    if start is None:
        out = [_ef_leaf(d, e, quant, stacked=stacked) for d, e in
               zip(tree_leaves(delta), tree_leaves(err), strict=True)]
    else:
        # delta is the trained tree: one leaf's delta at a time
        out = []
        for y, e, x in zip(tree_leaves(delta), tree_leaves(err),
                           tree_leaves(start), strict=True):
            deq, res = _ef_leaf(y.float() - x.float(), e, quant,
                                stacked=stacked)
            out.append((x.float() + deq, res))
    return (tree_unflatten(delta, [o[0] for o in out]),
            tree_unflatten(delta, [o[1] for o in out]))


def ef_roundtrip(delta, err, quant: str, *, start=None):
    """One client's error-feedback round trip over a params-congruent
    tree: ``v = delta + err`` is quantized leaf by leaf (one scale a
    leaf); returns ``(dequantized, v - dequantized)``.  The caller
    aggregates ``start + dequantized`` and keeps the residual as the
    client's next error row.  Given ``start``, ``delta`` is the trained
    tree, its delta is taken against ``start`` leaf by leaf, and the
    first result is ``start + dequantized``."""
    return _ef_tree(delta, err, quant, False, start)


def ef_roundtrip_stacked(delta, err, quant: str, *, start=None):
    """The vectorized engine's form: every leaf has a leading client axis
    (C, ...), and each client gets its own scale a leaf, so row c equals
    :func:`ef_roundtrip` of client c.  ``start`` as there: (C, ...) rows,
    or one row every client starts from."""
    return _ef_tree(delta, err, quant, True, start)


# ---------------------------------------------------------------------------
# bytes on the wire (host, exact)
# ---------------------------------------------------------------------------

def tree_counts(tree) -> Tuple[int, int]:
    """(total elements, number of leaves)."""
    leaves = tree_leaves(tree)
    return int(sum(int(x.numel()) for x in leaves)), len(leaves)


def uplink_bytes(tree, quant: str = "none") -> int:
    """One client->edge upload of ``tree``: 1 byte an element plus a
    4-byte scale a leaf when quantized; with ``"none"`` the fp32 master
    delta, whatever the compute precision (the server needs the fp32
    result)."""
    n, leaves = tree_counts(tree)
    if quant == "none":
        return n * 4
    return n * 1 + leaves * 4


def downlink_bytes(tree, precision: str) -> int:
    """One broadcast: the compute-dtype cast clients consume."""
    return tree_counts(tree)[0] * _PRECISION_BYTES[precision]
