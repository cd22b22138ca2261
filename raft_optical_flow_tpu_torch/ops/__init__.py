"""Tensor ops of the RAFT, LiteFlowNet3, SimpleFlowNet and IFNet paths, NHWC at
their public surface."""

from raft_optical_flow_tpu_torch.ops.corr import (
    avg_pool2x2,
    build_corr_pyramid_from_fmaps,
    corr_pyramid_lookup,
    sample_corr_window,
)
from raft_optical_flow_tpu_torch.ops.grid import (
    bilinear_sampler,
    coords_grid,
    resize_bilinear,
    resize_bilinear_align_corners,
    resize_nearest,
    upflow8,
)
from raft_optical_flow_tpu_torch.ops.padding import InputPadder, InputScaler
from raft_optical_flow_tpu_torch.ops.spatial_corr import spatial_correlation_sample
from raft_optical_flow_tpu_torch.ops.upsample import convex_upsample
from raft_optical_flow_tpu_torch.ops.warp import backward_warp, flow_to_warp, warp_lfn3

__all__ = [
    "avg_pool2x2",
    "build_corr_pyramid_from_fmaps",
    "corr_pyramid_lookup",
    "sample_corr_window",
    "bilinear_sampler",
    "coords_grid",
    "resize_bilinear",
    "resize_bilinear_align_corners",
    "resize_nearest",
    "upflow8",
    "InputPadder",
    "InputScaler",
    "spatial_correlation_sample",
    "convex_upsample",
    "backward_warp",
    "flow_to_warp",
    "warp_lfn3",
]
