"""Tensor ops of the RAFT path, NHWC at their public surface."""

from raft_optical_flow_tpu_torch.ops.corr import (
    avg_pool2x2,
    build_corr_pyramid_from_fmaps,
    corr_pyramid_lookup,
    sample_corr_window,
)
from raft_optical_flow_tpu_torch.ops.grid import (
    coords_grid,
    resize_bilinear_align_corners,
    upflow8,
)
from raft_optical_flow_tpu_torch.ops.padding import InputPadder
from raft_optical_flow_tpu_torch.ops.upsample import convex_upsample

__all__ = [
    "avg_pool2x2",
    "build_corr_pyramid_from_fmaps",
    "corr_pyramid_lookup",
    "sample_corr_window",
    "coords_grid",
    "resize_bilinear_align_corners",
    "upflow8",
    "InputPadder",
    "convex_upsample",
]
