"""Supervised flow losses."""

from raft_optical_flow_tpu_torch.losses.sequence import sequence_loss

__all__ = ["sequence_loss"]
