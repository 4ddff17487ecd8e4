"""Bytes-on-wire accounting (``repro/fl/compress.py:tree_counts,
uplink_bytes, downlink_bytes``), for the uncompressed uplink: the port's
trainer ships fp32 deltas.  The int8/fp8 uplink with error feedback is
not ported yet."""
from __future__ import annotations

from typing import Tuple

from repro_torch.tree import tree_leaves

# the reference's uplink dtypes; only "none" is ported (ROADMAP A.10)
QUANTS = ("none", "int8", "fp8")
_PRECISION_BYTES = {"": 4, "fp32": 4, "bf16": 2}


def tree_counts(tree) -> Tuple[int, int]:
    """(total elements, number of leaves)."""
    leaves = tree_leaves(tree)
    return int(sum(int(x.numel()) for x in leaves)), len(leaves)


def uplink_bytes(tree) -> int:
    """One client->edge upload: the fp32 master delta, 4 bytes a
    parameter, whatever the compute precision (the reference's
    ``quant="none"``)."""
    return tree_counts(tree)[0] * 4


def downlink_bytes(tree, precision: str) -> int:
    """One broadcast: the compute-dtype cast clients consume."""
    return tree_counts(tree)[0] * _PRECISION_BYTES[precision]
