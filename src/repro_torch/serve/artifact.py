"""Checkpoint -> servable artifact (``repro/serve/artifact.py``).

Any checkpoint in the shared npz + manifest format works, whichever
package wrote it: a trainer dump whose metadata carries ``cfg`` (FedPhD
stores the post-prune config there) or an experiment artifact whose
metadata carries ``spec.model``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, config_from_dict
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning.criteria import l2_scores, random_scores
from repro_torch.core.pruning.groups import build_groups
from repro_torch.core.pruning.masks import make_masks
from repro_torch.device import resolve_device


def load_serving_artifact(path: str, *, device="cuda"
                          ) -> Tuple[Any, ModelConfig, Dict]:
    """Load ``(params, cfg, meta)`` for :class:`DiffusionServer`, with
    the parameters on ``device``."""
    dev = resolve_device(device)
    arrays, meta = checkpoint.load(path)
    if "params" not in arrays:
        raise ValueError(f"checkpoint at {path!r} has no 'params' entry — "
                         f"not a trainer/experiment artifact")
    if meta.get("cfg"):
        cfg = config_from_dict(meta["cfg"])
    elif meta.get("spec", {}).get("model"):
        cfg = get_config(meta["spec"]["model"])
    else:
        raise ValueError(f"checkpoint at {path!r} carries neither a model "
                         f"cfg nor a spec to derive one from")
    if cfg.arch_type != "unet":
        raise ValueError(f"repro_torch.serve samples diffusion U-Nets; "
                         f"checkpoint is arch_type={cfg.arch_type!r}")
    return params_from_jax(arrays["params"], dev), cfg, meta


def masks_for_ratio(params, cfg: ModelConfig, ratio: float, *,
                    criterion: str = "l2") -> Dict[str, np.ndarray]:
    """Serving masks at ``ratio`` as host numpy arrays, the type that
    selects the gather route.  ``l2`` scores run the group sum-of-squares
    kernel on the parameters' device."""
    groups = build_groups(cfg, params)
    if criterion == "l2":
        scores = l2_scores(params, groups)
    elif criterion == "random":
        device = params["conv_in"]["w"].device
        gen = torch.Generator(device)
        gen.manual_seed(0)
        scores = random_scores(gen, groups, device=device)
    else:
        raise ValueError(f"unknown criterion {criterion!r}")
    masks = make_masks(scores, groups, ratio)
    return {k: v.cpu().numpy() for k, v in masks.items()}
