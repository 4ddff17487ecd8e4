"""DDIM sampler (Song et al. 2021; paper Eqs. 8-9), the port of
``repro/diffusion/ddim.py``.

:func:`ddim_step` takes per-sample timesteps, so the continuous-batching
server advances slots at different depths in one batch;
:func:`ddim_sample` is the whole trajectory built on the same step.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.diffusion.schedule import DiffusionSchedule


def ddim_timesteps(num_train_steps: int, num_sample_steps: int) -> np.ndarray:
    """Descending int64 sub-sequence of training timesteps: the classic
    stride ``(S-1)*stride, ..., 0`` when S divides T, else
    ``round(linspace(T-1, 0, S))``; S = 1 gives ``[T-1]``."""
    if not 1 <= num_sample_steps <= num_train_steps:
        raise ValueError(f"num_sample_steps={num_sample_steps} must be in "
                         f"[1, num_train_steps={num_train_steps}]")
    if num_sample_steps == 1:
        return np.array([num_train_steps - 1], np.int64)
    if num_train_steps % num_sample_steps == 0:
        stride = num_train_steps // num_sample_steps
        return np.arange(num_sample_steps - 1, -1, -1, dtype=np.int64) * stride
    ts = np.linspace(num_train_steps - 1, 0.0, num_sample_steps,
                     dtype=np.float32)
    return np.round(ts).astype(np.int64)


def ddim_step(x: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
              eps: torch.Tensor, schedule: DiffusionSchedule, *,
              eta: float = 0.0, z: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """One DDIM update x_t -> x_{t_prev} given the predicted noise.

    ``t`` / ``t_prev``: per-sample ``(B,)`` integer timesteps on x's
    device; ``t_prev == -1`` marks the final step to x_0.  x0 is clipped
    to [-1, 1].  ``eta > 0`` adds the Eq. 9 stochastic term and needs
    ``z`` shaped like x.  The update runs in fp32 whatever eps's dtype.
    """
    bshape = (-1,) + (1,) * (x.dim() - 1)
    ab = schedule.alpha_bars
    abar_t = ab[t].reshape(bshape)
    abar_prev = torch.where(t_prev >= 0, ab[t_prev.clamp(min=0)],
                            torch.ones_like(ab[0])).reshape(bshape)
    eps = eps.float()
    x0_pred = ((x - torch.sqrt(1.0 - abar_t) * eps)
               / torch.sqrt(abar_t)).clamp(-1.0, 1.0)
    if eta == 0.0:
        return (torch.sqrt(abar_prev) * x0_pred
                + torch.sqrt((1.0 - abar_prev).clamp(min=0.0)) * eps)
    if z is None:
        raise ValueError("eta > 0 needs the stochastic term's noise z")
    sigma = eta * torch.sqrt((1.0 - abar_prev) / (1.0 - abar_t)) \
        * torch.sqrt(1.0 - abar_t / abar_prev)
    return (torch.sqrt(abar_prev) * x0_pred
            + torch.sqrt((1.0 - abar_prev - sigma ** 2).clamp(min=0.0)) * eps
            + sigma * z)


def ddim_sample(eps_fn: Callable, schedule: DiffusionSchedule, shape, *,
                num_steps: int = 100, eta: float = 0.0,
                x_init: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Generate samples.  ``eps_fn(x_t, t: (B,)) -> eps``.

    ``x_init`` supplies the x_T draw; otherwise it and (for eta > 0) each
    step's z are drawn from ``generator`` on the schedule's device.
    """
    device = schedule.betas.device
    if x_init is None:
        x_init = torch.randn(shape, generator=generator, device=device)
    ts = ddim_timesteps(schedule.num_steps, num_steps)
    ts_prev = np.append(ts[1:], -1)
    x = x_init.float()
    for i in range(num_steps):
        t = torch.full((shape[0],), int(ts[i]), dtype=torch.int64,
                       device=device)
        tp = torch.full_like(t, int(ts_prev[i]))
        eps = eps_fn(x, t)
        z = None if eta == 0.0 else torch.randn(shape, generator=generator,
                                                device=device)
        x = ddim_step(x, t, tp, eps, schedule, eta=eta, z=z)
    return x
