"""Training of the port: AdamW, gradient compression, the train step."""
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, lr_at)
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             lm_loss, make_train_step)

__all__ = ["AdamWConfig", "TrainConfig", "adamw_update", "init_opt_state",
           "init_train_state", "lm_loss", "lr_at", "make_train_step"]
