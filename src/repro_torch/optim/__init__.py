from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.ema import ema_init, ema_update

__all__ = ["AdamState", "adam_init", "adam_update", "ema_init", "ema_update"]
