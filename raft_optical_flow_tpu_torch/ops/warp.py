"""Backward warping and forward splatting.

Counterpart of `raft_optical_flow_tpu/ops/warp.py`: `flow_to_warp`,
`backward_warp`, `warp_lfn3`, `forward_splat` and `forward_splat_range_map`.
NHWC at the surface; NHWC views of contiguous NCHW tensors pass without a
copy.

The splats scatter-add. CUDA adds floats with atomics in whatever order the
threads arrive, so a float scatter would differ from run to run on the
card. `fixed_point_sum` adds integers instead: each value rounded to a
multiple of 2^-bits, summed exactly in int64, rounded once to the float
dtype. Integer addition is associative, so the order cannot change the
sum: the same bits on every run, on the card and on the CPU.
"""

from __future__ import annotations

import math

import torch

from raft_optical_flow_tpu_torch.ops.grid import bilinear_sampler, coords_grid, widen

#: Largest magnitude `fixed_point_sum` lets a partial sum reach: 2^62, a
#: factor 2 inside int64.
FIXED_POINT_LIMIT = 2.0**62


def fixed_point_sum(index: torch.Tensor, values: torch.Tensor, size: int,
                    bits: int) -> torch.Tensor:
    """Per batch row b, values[b] summed into `size` bins at index[b].

    index [B, Q] in [0, size); values [B, Q] or [B, Q, C]. Returns [B, size]
    or [B, size, C] in values' dtype: the exact sum of the values rounded to
    multiples of 2^-bits, then rounded once to the dtype. A bin of n values
    is within n * 2^-(bits+1) of their exact sum before that last rounding.
    The caller keeps every partial sum below 2^63 / 2^bits. No gradient.
    """
    B, Q = index.shape
    C = values.shape[2] if values.dim() == 3 else 1
    rows = torch.arange(B, device=index.device)[:, None] * size
    flat = (index + rows).reshape(B * Q, 1) * C + torch.arange(C, device=index.device)
    fixed = torch.round(values.detach().double() * 2.0**bits).long()
    acc = torch.zeros(B * size * C, dtype=torch.int64, device=index.device)
    acc.index_add_(0, flat.reshape(-1), fixed.reshape(-1))
    out = (acc.double() * 2.0**-bits).to(values.dtype)
    return out.reshape((B, size, C) if values.dim() == 3 else (B, size))


def splat_bits(values: torch.Tensor) -> int:
    """The fraction bits of `ForwardSplat`'s fixed point for values [B, Q, C]:
    the most that keeps every partial sum of a batch row, whatever the
    order, within FIXED_POINT_LIMIT (sum |v| * 2^bits <= 2^62). Reads the
    sum on the host. Raises on a value that is not finite."""
    total = float(values.detach().double().abs().sum(dim=(1, 2)).max()) if values.numel() else 0.0
    if not math.isfinite(total):
        raise ValueError("forward_splat: the splatted values are not all finite")
    if total == 0.0:
        return 0
    return math.floor(math.log2(FIXED_POINT_LIMIT / total))


class ForwardSplat(torch.autograd.Function):
    """apply(index [B, Q], values [B, Q, C], size) -> [B, size, C]: the
    values summed into their bins by `fixed_point_sum` at `splat_bits`. The
    backward is a gather of the output cotangent at each value's bin (no
    atomics: the same bits on every run)."""

    @staticmethod
    def forward(ctx, index, values, size):
        ctx.save_for_backward(index)
        return fixed_point_sum(index, values, size, splat_bits(values))

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        C = g.shape[2]
        return None, torch.gather(g, 1, index[..., None].expand(*index.shape, C)), None


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """Pixel-coordinate warp grid [N, H, W, 2]: (x, y) + flow, flow [N, H, W, 2].

    The coords are fp32 whatever flow's dtype: a bf16 grid would round
    absolute positions (4 px apart at x ~ 1024); the flow values round once,
    the positions must not. A float64 flow keeps float64 coords.
    """
    N, H, W, _ = flow.shape
    flow = widen(flow)
    return coords_grid(N, H, W, device=flow.device, dtype=flow.dtype) + flow


def backward_warp(img: torch.Tensor, flow: torch.Tensor, padding: str = "zeros",
                  return_mask: bool = False):
    """img [N, H, W, C] sampled at grid + flow (flow [N, H, W, 2], (x, y)),
    `bilinear_sampler` with `padding` "zeros" or "border"; with
    `return_mask`, also its open-interval in-bounds mask [N, H, W]."""
    return bilinear_sampler(img, flow_to_warp(flow), padding=padding, return_mask=return_mask)


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
    flow = widen(flow)
    inv = torch.tensor(1.0, dtype=flow.dtype) / torch.tensor(div_flow, dtype=flow.dtype)
    coords = coords_grid(N, H, W, device=x.device, dtype=flow.dtype) + flow * inv
    warped = bilinear_sampler(x, coords)
    px, py = coords[..., 0], coords[..., 1]
    mask = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    return warped * mask[..., None].to(warped.dtype)


def forward_splat(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img [N, H, W, C] forward-warped by flow [N, H, W, 2] with bilinear
    splatting, unnormalized: each pixel adds its value times each of the
    four bilinear weights at grid + flow to the pixel of that tap; taps
    outside the image drop. Returns [N, H, W, C] in img's dtype, summed in
    fp32 (float64 for float64) and rounded once (the reference's
    `unflow_ops_pytorch.py` scatter, density for img = ones).

    Differentiable in img and flow, as in the JAX package: the weights are
    autograd's, the sum `ForwardSplat`'s, whose backward is a gather.

    Error bound: every weight times value is rounded to a multiple of
    2^-bits with bits = floor(log2(2^62 / S)), S the largest sum of |weight
    * value| over a batch row; an output element of n contributions is
    within n * 2^-(bits+1) of their exact sum before its rounding to the
    dtype. At a 1024x440 frame of values in [0, 255] (S < 2^27) that is
    under 2^-36 per contribution.
    """
    N, H, W, C = img.shape
    coords = flow_to_warp(flow)
    x = coords[..., 0].reshape(N, -1)
    y = coords[..., 1].reshape(N, -1)
    vals = img.reshape(N, H * W, C)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.clamp(-2, W).long()  # clamp in float before the int cast
    y0i = y0.clamp(-2, H).long()
    index, contrib = [], []
    for xi, yi, wgt in ((x0i, y0i, (1 - wx) * (1 - wy)), (x0i + 1, y0i, wx * (1 - wy)),
                        (x0i, y0i + 1, (1 - wx) * wy), (x0i + 1, y0i + 1, wx * wy)):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        index.append(yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        wgt = torch.where(inb, wgt, torch.zeros((), dtype=wgt.dtype, device=wgt.device))
        contrib.append(wgt[..., None] * widen(vals))
    out = ForwardSplat.apply(torch.cat(index, dim=1), torch.cat(contrib, dim=1), H * W)
    return out.to(img.dtype).reshape(N, H, W, C)


def forward_splat_range_map(flow: torch.Tensor) -> torch.Tensor:
    """How often each pixel is hit by grid + flow: the four bilinear weights
    of every pixel scatter-added, [N, H, W, 1] in flow's dtype (UFlow's
    `compute_range_map` at downsampling factor 1), `forward_splat` of ones
    with its bound, and differentiable in flow."""
    N, H, W, _ = flow.shape
    ones = torch.ones(N, H, W, 1, dtype=flow.dtype, device=flow.device)
    return forward_splat(ones, flow)
