"""Exponential moving average of parameters (``repro/optim/ema.py``; Ho
et al. 2020), in fp32 whatever the parameters' dtype.  The paper keeps
an EMA in centralized training only
(:func:`repro_torch.fl.baselines.run_centralized`)."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


@torch.no_grad()
def ema_init(params):
    return tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)


@torch.no_grad()
def ema_update(ema, params, decay: float = 0.9999):
    """``decay * e + (1 - decay) * p`` leaf by leaf, as new tensors."""
    return tree_map(lambda e, p: decay * e + (1.0 - decay) * p.float(),
                    ema, params)
