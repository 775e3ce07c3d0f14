"""Training (``repro.training`` counterpart): the train step, the
checkpointed ``Trainer`` (on one device or a mesh), elastic restart
(``reshard_for_mesh``), the straggler watchdog, and the GPipe pipeline
(``training.pipeline``)."""

from repro_torch.training.pipeline import gpipe_forward, gpipe_loss_fn
from repro_torch.training.train_loop import (
    TrainConfig,
    Trainer,
    TrainResult,
    make_train_step,
    reshard_for_mesh,
    value_and_grad,
)
from repro_torch.training.watchdog import StragglerWatchdog

__all__ = ["TrainConfig", "Trainer", "TrainResult", "make_train_step", "reshard_for_mesh", "value_and_grad",
           "StragglerWatchdog", "gpipe_forward", "gpipe_loss_fn"]
