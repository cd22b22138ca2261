"""Tensor ops of the RAFT, LiteFlowNet3, SimpleFlowNet and IFNet paths, NHWC at
their public surface: every name of the JAX package's `ops`, and the port's
own helpers beside them."""

from raft_optical_flow_tpu_torch.ops.corr import (
    all_pairs_correlation,
    avg_pool2x2,
    build_corr_pyramid,
    build_corr_pyramid_from_fmaps,
    corr_pyramid_lookup,
    sample_corr_window,
)
from raft_optical_flow_tpu_torch.ops.grid import (
    bilinear_sampler,
    coords_grid,
    grid_sample_nearest,
    resize_bilinear,
    resize_bilinear_align_corners,
    resize_nearest,
    upflow8,
    upflow_n,
)
from raft_optical_flow_tpu_torch.ops.padding import InputPadder, InputScaler
from raft_optical_flow_tpu_torch.ops.spatial_corr import (
    spatial_correlation_sample,
    translated_spatial_correlation_sample,
)
from raft_optical_flow_tpu_torch.ops.upsample import convex_upsample
from raft_optical_flow_tpu_torch.ops.warp import (
    backward_warp,
    flow_to_warp,
    forward_splat,
    forward_splat_range_map,
    warp_lfn3,
)

__all__ = [
    "all_pairs_correlation",
    "avg_pool2x2",
    "build_corr_pyramid",
    "build_corr_pyramid_from_fmaps",
    "corr_pyramid_lookup",
    "sample_corr_window",
    "bilinear_sampler",
    "coords_grid",
    "grid_sample_nearest",
    "resize_bilinear",
    "resize_bilinear_align_corners",
    "resize_nearest",
    "upflow8",
    "upflow_n",
    "InputPadder",
    "InputScaler",
    "spatial_correlation_sample",
    "translated_spatial_correlation_sample",
    "convex_upsample",
    "backward_warp",
    "flow_to_warp",
    "forward_splat",
    "forward_splat_range_map",
    "warp_lfn3",
]
