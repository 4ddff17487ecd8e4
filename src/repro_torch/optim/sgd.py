"""SGD with optional momentum (``repro/optim/sgd.py``; Alg. 2 uses plain
SGD updates).  Functional, as the reference: fp32 arithmetic, momentum
buffers in fp32, params cast back to their dtype."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map


class SGDState(NamedTuple):
    momentum: Any


def sgd_init(params, momentum: float = 0.0) -> SGDState:
    if momentum == 0.0:
        return SGDState(momentum=None)
    return SGDState(momentum=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


@torch.no_grad()
def sgd_update(grads, state: SGDState, params, *, lr: float,
               momentum: float = 0.0):
    """One step.  Returns (new params, new state)."""
    if momentum == 0.0 or state.momentum is None:
        return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                        params, grads), state
    new_m = tree_map(lambda m, g: momentum * m + g.float(), state.momentum,
                     grads)
    new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                          params, new_m)
    return new_params, SGDState(momentum=new_m)
