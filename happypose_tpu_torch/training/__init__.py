"""Training: losses, the optimizer and the train step (on one device or
data-parallel over a mesh axis), synthetic batches (PyTorch port of `happypose_tpu/training/`)."""

from happypose_tpu_torch.training.losses import (
    coarse_classification_loss,
    loss_refiner_CO_disentangled_reference_point,
)
from happypose_tpu_torch.training.trainer import (
    TrainState,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "loss_refiner_CO_disentangled_reference_point",
    "coarse_classification_loss",
    "TrainState",
    "make_optimizer",
    "make_train_step",
]
