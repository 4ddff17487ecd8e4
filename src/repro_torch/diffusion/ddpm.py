"""DDPM forward process and training loss (``repro/diffusion/ddpm.py``;
paper Eqs. 5-7, Alg. 2 lines 6-12).

The timesteps and the noise come from an explicit ``torch.Generator``
(t first, then eps, as the reference splits its key), or are given by
the caller: the port cannot reproduce ``jax.random`` streams, so parity
tests inject the same draws into both packages.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.diffusion.schedule import DiffusionSchedule


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """Forward noising: x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    abar = schedule.alpha_bars[t.long()]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (torch.sqrt(abar).reshape(shape) * x0
            + torch.sqrt(1.0 - abar).reshape(shape) * eps)


def ddpm_loss(eps_fn: Callable, schedule: DiffusionSchedule,
              x0: torch.Tensor, generator: Optional[torch.Generator] = None,
              *, t: Optional[torch.Tensor] = None,
              eps: Optional[torch.Tensor] = None,
              clients: Optional[int] = None) -> torch.Tensor:
    """Simplified DDPM loss (Eq. 6): mean ||eps - eps_theta(x_t, t)||^2.

    ``eps_fn(x_t, t)`` predicts the noise; x0 (B, H, W, C) in [-1, 1].
    ``t`` (B,) and ``eps`` (like x0) are drawn from ``generator`` unless
    given.  ``clients=C``: x0's batch holds C clients' batches one after
    another, and the result is each client's mean, (C,)."""
    if (t is None or eps is None) and generator is None:
        raise ValueError("ddpm_loss draws t and eps from a generator: pass "
                         "generator=, or both t= and eps=")
    B = x0.shape[0]
    if t is None:
        t = torch.randint(0, schedule.num_steps, (B,), generator=generator,
                          device=x0.device)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                          dtype=x0.dtype)
    pred = eps_fn(q_sample(schedule, x0, t, eps), t)
    if clients is None:
        return torch.mean(torch.square(eps - pred))
    return torch.mean(torch.square(eps - pred).reshape(clients, -1), dim=1)
