"""Flow losses: RAFT's sequence loss, LiteFlowNet3's multi-scale loss,
SimpleFlowNet's supervised and unsupervised losses, IFNet's LapLoss, and
the UFlow and UnFlow unsupervised-loss libraries (modules `uflow`,
`unflow`)."""

from raft_optical_flow_tpu_torch.losses.laploss import lap_loss, laploss
from raft_optical_flow_tpu_torch.losses.sequence import multiscale_sequence_loss, sequence_loss
from raft_optical_flow_tpu_torch.losses.simple_flow_loss import (
    edge_aware_smoothness,
    simple_flow_loss,
)
from raft_optical_flow_tpu_torch.losses.unsupervised import unsupervised_loss
from raft_optical_flow_tpu_torch.losses import uflow, unflow

__all__ = [
    "sequence_loss",
    "multiscale_sequence_loss",
    "simple_flow_loss",
    "edge_aware_smoothness",
    "lap_loss",
    "laploss",
    "unsupervised_loss",
    "uflow",
    "unflow",
]
