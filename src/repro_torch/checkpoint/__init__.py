from repro_torch.checkpoint.ckpt import load, save

__all__ = ["save", "load"]
