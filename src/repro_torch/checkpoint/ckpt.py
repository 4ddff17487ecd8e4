"""Checkpointing: nested dict/list tree <-> flat npz with a structure
manifest.

The format is the reference package's (the same npz member names and
manifest), except that the port stores the members uncompressed: a
checkpoint written by either package loads in the other, since
``np.load`` reads both.  fp32 weights compress little and zlib is slow
on them: compressing a flat baseline's (N, ...) method state (SCAFFOLD's
c_i, MOON's previous models) took longer than its training.  Leaves may be numpy arrays or torch tensors (saved as numpy, so float32
and integer types only); :func:`load` returns numpy leaves.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np


def _to_numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):                 # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/[{i}]"))
    elif tree is None:
        out[prefix + "/__none__"] = np.zeros((0,))
    else:
        out[prefix] = _to_numpy(tree)
    return out


def _structure(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__list__": [_structure(v) for v in tree]}
    if tree is None:
        return "__none__"
    return "__leaf__"


def save(path: str, tree, metadata: Dict[str, Any] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **flat)
    manifest = {"structure": _structure(tree), "metadata": metadata or {}}
    with open(path + ".manifest.json", "w") as f:
        json.dump(manifest, f)


def _rebuild(struct, flat: Dict[str, np.ndarray], prefix: str = ""):
    if struct == "__leaf__":
        return flat[prefix]
    if struct == "__none__":
        return None
    if isinstance(struct, dict):
        if "__tuple__" in struct:
            return tuple(_rebuild(s, flat, f"{prefix}/[{i}]")
                         for i, s in enumerate(struct["__tuple__"]))
        if "__list__" in struct:
            return [_rebuild(s, flat, f"{prefix}/[{i}]")
                    for i, s in enumerate(struct["__list__"])]
        return {k: _rebuild(v, flat, f"{prefix}/{k}")
                for k, v in struct.items()}
    raise ValueError(f"bad manifest node {struct!r}")


def load(path: str) -> Tuple[Any, Dict[str, Any]]:
    with open(path + ".manifest.json") as f:
        manifest = json.load(f)
    if not path.endswith(".npz"):
        path = path + ".npz" if os.path.exists(path + ".npz") else path
    data = dict(np.load(path, allow_pickle=False))
    tree = _rebuild(manifest["structure"], data)
    return tree, manifest["metadata"]
