"""DDPM training loss and DDIM sampling on a linear (or cosine) noise
schedule."""
from repro_torch.diffusion.ddim import ddim_sample, ddim_step, ddim_timesteps
from repro_torch.diffusion.ddpm import ddpm_loss, q_sample
from repro_torch.diffusion.sampling import sample_images
from repro_torch.diffusion.schedule import (DiffusionSchedule,
                                            cosine_schedule, linear_schedule)

__all__ = ["DiffusionSchedule", "cosine_schedule", "ddim_sample",
           "ddim_step", "ddim_timesteps", "ddpm_loss", "linear_schedule",
           "q_sample", "sample_images"]
