"""DDPM training loss and DDIM sampling on a linear noise schedule."""
from repro_torch.diffusion.ddim import ddim_sample, ddim_step, ddim_timesteps
from repro_torch.diffusion.ddpm import ddpm_loss, q_sample
from repro_torch.diffusion.schedule import DiffusionSchedule, linear_schedule

__all__ = ["DiffusionSchedule", "ddim_sample", "ddim_step", "ddim_timesteps",
           "ddpm_loss", "linear_schedule", "q_sample"]
