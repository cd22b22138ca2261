"""Evaluation: validation metrics, benchmark submissions, warm-start helpers."""

from raft_optical_flow_tpu_torch.eval.evaluate import (
    forward_interpolate,
    make_lfn3_forward,
    make_raft_forward,
    validate_chairs,
    validate_kitti,
    validate_sintel,
)

__all__ = [
    "validate_chairs",
    "validate_sintel",
    "validate_kitti",
    "forward_interpolate",
    "make_raft_forward",
    "make_lfn3_forward",
]
