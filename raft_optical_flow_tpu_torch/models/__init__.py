"""Models: RAFT (standard and small), LiteFlowNet3 (standard, S, and either
with PseudoReg), SimpleFlowNet and IFNet."""

from raft_optical_flow_tpu_torch.models.ifnet import IFNet, ifnet
from raft_optical_flow_tpu_torch.models.liteflownet3 import (
    LFN3Config,
    LiteFlowNet3,
    liteflownet3,
    liteflownet3_pseudoreg,
    liteflownet3s,
    liteflownet3s_pseudoreg,
)
from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.models.simple_flow import (
    SimpleFlowConfig,
    SimpleFlowNet,
    simple_flow_net,
)

__all__ = [
    "RAFT",
    "RAFTConfig",
    "LFN3Config",
    "LiteFlowNet3",
    "liteflownet3",
    "liteflownet3_pseudoreg",
    "liteflownet3s",
    "liteflownet3s_pseudoreg",
    "SimpleFlowConfig",
    "SimpleFlowNet",
    "simple_flow_net",
    "IFNet",
    "ifnet",
]
