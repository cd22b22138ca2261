"""Supervised flow losses."""

from raft_optical_flow_tpu_torch.losses.sequence import multiscale_sequence_loss, sequence_loss

__all__ = ["sequence_loss", "multiscale_sequence_loss"]
