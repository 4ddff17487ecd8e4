"""Noise schedules for DDPM/DDIM (``repro/diffusion/schedule.py``): the
linear schedule the trainer and sampler use, and the cosine schedule
(Nichol & Dhariwal 2021)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor          # (T,)
    alphas: torch.Tensor         # (T,)
    alpha_bars: torch.Tensor     # (T,) cumulative products

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]


def linear_schedule(num_steps: int, beta_start: float = 1e-4,
                    beta_end: float = 0.02, *,
                    device="cuda") -> DiffusionSchedule:
    betas = torch.linspace(beta_start, beta_end, num_steps,
                           dtype=torch.float32, device=device)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas=betas, alphas=alphas,
                             alpha_bars=torch.cumprod(alphas, dim=0))


def cosine_schedule(num_steps: int, s: float = 0.008, *,
                    device="cuda") -> DiffusionSchedule:
    t = torch.arange(num_steps + 1, dtype=torch.float32,
                     device=device) / num_steps
    f = torch.cos((t + s) / (1 + s) * torch.pi / 2) ** 2
    alpha_bars = f / f[0]
    betas = torch.clamp(1.0 - alpha_bars[1:] / alpha_bars[:-1], 0.0, 0.999)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas=betas, alphas=alphas,
                             alpha_bars=torch.cumprod(alphas, dim=0))
