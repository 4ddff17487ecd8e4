from repro_torch.optim.adam import (AdamState, adam_from_tree, adam_init,
                                    adam_update, adam_update_)
from repro_torch.optim.ema import ema_init, ema_update
from repro_torch.optim.schedules import constant, cosine_decay
from repro_torch.optim.sgd import SGDState, sgd_init, sgd_update

__all__ = ["AdamState", "adam_from_tree", "adam_init", "adam_update",
           "adam_update_", "SGDState", "sgd_init", "sgd_update", "ema_init",
           "ema_update", "constant", "cosine_decay"]
