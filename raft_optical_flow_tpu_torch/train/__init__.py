"""RAFT training: stage configs and the trainer."""

from raft_optical_flow_tpu_torch.train.configs import STANDARD_CURRICULUM, StageConfig
from raft_optical_flow_tpu_torch.train.trainer import (
    RAFTTrainer,
    TrainState,
    make_optimizer,
    raft_train_step,
)

__all__ = [
    "RAFTTrainer",
    "TrainState",
    "make_optimizer",
    "raft_train_step",
    "StageConfig",
    "STANDARD_CURRICULUM",
]
