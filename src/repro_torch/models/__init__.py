"""The port's models: the DDPM U-Net and the decoder stack, behind
``model`` (``repro/models``; the port has no ``ApplyOptions``: ``remat``
is an argument of the forward and the loss)."""
from repro_torch.models import model

__all__ = ["model"]
