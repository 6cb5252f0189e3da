"""Training of the port: schedules, optimizers, the train step, Trainer."""

from pointnet2_tpu_torch.train.state import TrainState, make_optimizer
from pointnet2_tpu_torch.train.trainer import TrainConfig, Trainer

__all__ = ["TrainConfig", "TrainState", "Trainer", "make_optimizer"]
