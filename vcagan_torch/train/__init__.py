"""The adversarial train step of the port (``vcagan/train`` in the JAX package)."""

from vcagan_torch.train.models import VCAGANModules
from vcagan_torch.train.schedule import multistep_schedule
from vcagan_torch.train.state import GANTrainState, create_train_state
from vcagan_torch.train.step import Batch, make_eval_step, make_train_step

__all__ = [
    "Batch",
    "GANTrainState",
    "VCAGANModules",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
    "multistep_schedule",
]
