"""Carry weights and masks between the JAX package and the port.

Both packages hold U-Net parameters as the same nested tree of dicts and
lists.  The JAX side hands it over as numpy leaves (``jax.tree.map(
np.asarray, params)``); :func:`params_from_jax` puts each leaf on a torch
device unchanged, and :func:`params_to_jax` returns numpy leaves the JAX
package accepts.  :func:`state_dict` flattens a tree to dotted keys that
follow the JAX tree paths (``down.1.blocks.0.attn.qkv.w``).  Masks
travel as numpy dicts keyed by PruneGroup name: the port's
``masks_for_ratio`` returns them, and :func:`masks_from_jax` takes the
reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree, device="cuda") -> Any:
    """Numpy (or JAX-array) leaves -> torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def params_to_jax(tree) -> Any:
    """Torch tensors -> numpy leaves (float32 tensors stay float32)."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return tree.detach().cpu().numpy()


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

