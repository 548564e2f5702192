"""The training program: the adversarial iteration (D step with lazy R1,
G step, Adam), checkpoints with resume, and the epoch loop
(``python -m mudiff_torch.cli.train``)."""

from mudiff_torch.train.state import TrainState, create_train_state
from mudiff_torch.train.steps import (
    TrainDraws,
    d_loss_and_grads,
    g_loss_and_grads,
    make_d_step,
    make_g_step,
    make_train_step,
)

__all__ = ["TrainState", "create_train_state", "TrainDraws", "d_loss_and_grads",
           "g_loss_and_grads", "make_d_step", "make_g_step", "make_train_step"]
