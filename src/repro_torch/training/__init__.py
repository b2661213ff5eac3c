"""Training of the port: optimizers, the train step (accumulation, remat,
gradient compression), checkpoints."""
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (AdamW, Adafactor,
                                            clip_by_global_norm,
                                            global_norm, make_optimizer)
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             causal_lm_loss,
                                             init_train_state,
                                             make_train_step,
                                             train_state_from_numpy)
