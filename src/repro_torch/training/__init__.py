"""Single-device training of the port: optimizers, checkpoints, the loop."""
from repro_torch.training.checkpoint import (latest_checkpoint,
                                             load_checkpoint,
                                             save_checkpoint)
from repro_torch.training.loop import TrainResult, train
from repro_torch.training.optim import (OptState, adafactor_init,
                                        adafactor_update, adamw_init,
                                        adamw_update, cosine_lr,
                                        make_optimizer)
