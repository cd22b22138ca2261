"""Backward warping.

Counterpart of `raft_optical_flow_tpu/ops/warp.py`: `flow_to_warp`,
`backward_warp` and `warp_lfn3` (the forward splats have no caller in
either package's models or losses and are not ported). NHWC at the
surface; NHWC views of contiguous NCHW tensors pass without a copy.
"""

from __future__ import annotations

import torch

from raft_optical_flow_tpu_torch.ops.grid import bilinear_sampler, coords_grid


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """Pixel-coordinate warp grid [N, H, W, 2]: (x, y) + flow, flow [N, H, W, 2].

    The coords are fp32 whatever flow's dtype: a bf16 grid would round
    absolute positions (4 px apart at x ~ 1024); the flow values round once,
    the positions must not.
    """
    N, H, W, _ = flow.shape
    return coords_grid(N, H, W, device=flow.device) + flow.float()


def backward_warp(img: torch.Tensor, flow: torch.Tensor, padding: str = "zeros") -> torch.Tensor:
    """img [N, H, W, C] sampled at grid + flow (flow [N, H, W, 2], (x, y)),
    `bilinear_sampler` with `padding` "zeros" or "border"."""
    return bilinear_sampler(img, flow_to_warp(flow), padding=padding)


def warp_lfn3(x: torch.Tensor, flow: torch.Tensor, div_flow: float = 1.0) -> torch.Tensor:
    """LiteFlowNet3's backward warp: x [N, H, W, C] sampled at grid + flow /
    div_flow (flow [N, H, W, 2], (x, y)), zero outside, times the mask of
    positions in the closed box 0 <= x <= W-1, 0 <= y <= H-1.

    The box is the JAX package's analytic form of the reference's mask (a
    sampled all-ones image thresholded at 1). The coords are fp32 whatever
    flow's dtype (see `flow_to_warp`). flow / div_flow is the product with
    div_flow's fp32 reciprocal, as XLA compiles a division by a constant
    (and as CUDA divides by a scalar): a position on the box's edge stays
    on it.
    """
    N, H, W, _ = x.shape
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(div_flow, dtype=torch.float32)
    coords = coords_grid(N, H, W, device=x.device) + flow.float() * inv
    warped = bilinear_sampler(x, coords)
    px, py = coords[..., 0], coords[..., 1]
    mask = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    return warped * mask[..., None].to(warped.dtype)
