"""DDIM sampling on a linear noise schedule."""
from repro_torch.diffusion.ddim import ddim_sample, ddim_step, ddim_timesteps
from repro_torch.diffusion.schedule import DiffusionSchedule, linear_schedule

__all__ = ["DiffusionSchedule", "ddim_sample", "ddim_step", "ddim_timesteps",
           "linear_schedule"]
