"""Models: RAFT (standard and small), test mode, materialized correlation."""

from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig

__all__ = ["RAFT", "RAFTConfig"]
