"""Carry weights and masks between the JAX package and the port.

Both packages hold U-Net and decoder parameters as the same nested tree
of dicts and lists (a decoder's unstacked ``head`` layers, its
``cycles`` stacked on a first axis, so an MoE layer's expert weights
are (n_cycles, E, d, d_expert) leaves, and its ``tail``).  The JAX side hands it over as numpy leaves
(``jax.tree.map(np.asarray, params)``); :func:`params_from_jax` puts
each leaf on a torch device unchanged, and :func:`params_to_jax` returns
numpy leaves the JAX package accepts.  :func:`state_dict` flattens a
tree to dotted keys that follow the JAX tree paths
(``down.1.blocks.0.attn.qkv.w``).  Masks
travel as numpy dicts keyed by PruneGroup name: the port's
``masks_for_ratio`` returns them, and :func:`masks_from_jax` takes the
reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf_from_jax(leaf, device) -> torch.Tensor:
    arr = np.array(leaf)
    # numpy holds JAX's bf16 as ml_dtypes.bfloat16, which torch cannot
    # read; bf16 -> fp32 is exact, so the leaf crosses as fp32 and is
    # cast back on the torch side
    if arr.dtype.name == "bfloat16":
        return torch.as_tensor(arr.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(arr, device=device)


def params_from_jax(tree, device="cuda") -> Any:
    """Numpy (or JAX-array) leaves -> torch tensors on ``device``; bf16
    leaves stay bf16 and ``None`` entries (the empty ``cycles`` slots of
    a decoder with no full pattern cycle) stay ``None``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if tree is None:
        return None
    return _leaf_from_jax(tree, device)


def params_to_jax(tree) -> Any:
    """Torch tensors -> numpy leaves (float32 tensors stay float32).
    numpy has no bf16 of its own, so bf16 tensors come back as float32
    arrays, which is exact; the JAX side casts them back
    (``.astype(jnp.bfloat16)``).  ``None`` entries stay ``None``."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    if tree is None:
        return None
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a parameter tree to ``{"down.1.blocks.0.res.conv1.w": t}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(state_dict(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def masks_from_jax(masks) -> Dict[str, np.ndarray]:
    """Reference masks (JAX or numpy arrays) -> host numpy masks, the
    type that selects the port's gather route."""
    return {k: np.array(v, np.float32) for k, v in masks.items()}

