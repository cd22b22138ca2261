"""UnFlow's standalone warp ops: the forward-splat density, the backward
warp, the occlusion mask; and the deterministic splat sum that both
forward splats of the port (this one and UFlow's range map) use.

Counterpart of `raft_optical_flow_tpu/ops/unflow_ops.py`. NHWC, flows
(x, y) in pixels.

The splats scatter-add bilinear weights. CUDA's `index_add_` adds floats
with atomics in whatever order the threads arrive, so a float splat would
differ from run to run on the card. `splat_sum` adds fixed-point integers
instead (`ops/warp.py::fixed_point_sum`): each weight rounded to a multiple
of 2^-SPLAT_BITS, summed exactly as int64, then rounded once to the float
dtype: the same bits on every run, on the card and on the CPU. The splats
feed only thresholded or stopped-gradient masks, so they carry no gradient.
"""

from __future__ import annotations

import torch

from raft_optical_flow_tpu_torch.ops.grid import coords_grid
from raft_optical_flow_tpu_torch.ops.warp import backward_warp, fixed_point_sum

#: Fraction bits of `splat_sum`'s fixed point: a weight's rounding error is
#: at most 2^-41, and 2^63 leaves room for sums below 2^22 in one bin.
SPLAT_BITS = 40


def splat_sum(index: torch.Tensor, weights: torch.Tensor, size: int) -> torch.Tensor:
    """Per batch row b, the sum of weights[b] into `size` bins at index[b]
    ([B, Q] each, indices in [0, size)): [B, size] in weights' dtype, the
    exact sum of the weights rounded to multiples of 2^-SPLAT_BITS."""
    return fixed_point_sum(index, weights, size, SPLAT_BITS)


@torch.no_grad()
def forward_warp_op(flow: torch.Tensor) -> torch.Tensor:
    """Density of the forward-splatted bilinear weights [B, H, W, 1].

    UnFlow's semantics: points whose (unfloored) target lies inside the
    image (0 <= x < W, 0 <= y < H) are kept, and their +1 taps are clamped
    into the image (border cells collect twice), not dropped, unlike UFlow's
    range map. The reference's `tensor[idx] += w` drops repeated indices (a
    torch quirk); this sums them, the intended accumulation, as the JAX
    package does. No gradient.
    """
    N, H, W, _ = flow.shape
    coords = coords_grid(N, H, W, device=flow.device, dtype=flow.dtype) + flow
    x = coords[..., 0].reshape(N, -1)
    y = coords[..., 1].reshape(N, -1)
    valid = (x >= 0) & (x < W) & (y >= 0) & (y < H)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = torch.clamp(x0.long(), 0, W - 1)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)

    vf = valid.to(flow.dtype)
    index = torch.cat([y0i * W + x0i, y1i * W + x0i, y0i * W + x1i, y1i * W + x1i], dim=1)
    weights = torch.cat([vf * (1 - wx) * (1 - wy), vf * (1 - wx) * wy,
                         vf * wx * (1 - wy), vf * wx * wy], dim=1)
    return splat_sum(index, weights, H * W).reshape(N, H, W, 1)


def backward_warp_op(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """image sampled at grid MINUS flow (bilinear, zeros outside).

    The sign is the reference's: this standalone op samples at
    (x - flow_x, y - flow_y), unlike `losses/unflow.py::image_warp` (grid +
    flow), a quirk the JAX package keeps.
    """
    return backward_warp(image, -flow, padding="zeros")


def _norm(x: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.norm(x, axis=3, keepdims=True)`: sqrt of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, dim=3, keepdim=True))


def occlusion_detection(flow_fw: torch.Tensor, flow_bw: torch.Tensor, alpha1: float = 0.01,
                        alpha2: float = 0.5) -> torch.Tensor:
    """Non-occlusion mask [B, H, W, 1] (1 visible, 0 occluded): both splat
    densities above alpha1, and forward-backward consistency
    |fw + warp(bw)| < alpha2 (|fw| + |warp(bw)| + 1e-6)."""
    density_mask_fw = (forward_warp_op(flow_fw) > alpha1).to(flow_fw.dtype)
    density_mask_bw = (forward_warp_op(flow_bw) > alpha1).to(flow_fw.dtype)

    flow_bw_warped = backward_warp_op(flow_bw, flow_fw)
    flow_diff = _norm(flow_fw + flow_bw_warped)
    flow_magnitude = _norm(flow_fw) + _norm(flow_bw_warped)
    consistency_mask = (flow_diff < alpha2 * (flow_magnitude + 1e-6)).to(flow_fw.dtype)
    return density_mask_fw * density_mask_bw * consistency_mask
