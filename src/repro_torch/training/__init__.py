"""Training (``repro.training`` counterpart, one device): the train step,
the checkpointed ``Trainer`` and the straggler watchdog."""

from repro_torch.training.train_loop import TrainConfig, Trainer, TrainResult, make_train_step, value_and_grad
from repro_torch.training.watchdog import StragglerWatchdog

__all__ = ["TrainConfig", "Trainer", "TrainResult", "make_train_step", "value_and_grad", "StragglerWatchdog"]
