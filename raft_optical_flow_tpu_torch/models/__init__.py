"""Models: RAFT (standard and small) and LiteFlowNet3 (standard, S, and
either with PseudoReg)."""

from raft_optical_flow_tpu_torch.models.liteflownet3 import (
    LFN3Config,
    LiteFlowNet3,
    liteflownet3,
    liteflownet3_pseudoreg,
    liteflownet3s,
    liteflownet3s_pseudoreg,
)
from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig

__all__ = [
    "RAFT",
    "RAFTConfig",
    "LFN3Config",
    "LiteFlowNet3",
    "liteflownet3",
    "liteflownet3_pseudoreg",
    "liteflownet3s",
    "liteflownet3s_pseudoreg",
]
