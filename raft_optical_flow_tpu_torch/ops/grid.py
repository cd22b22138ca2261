"""Coordinate grids and the align-corners resize behind `upflow8`.

Counterpart of `raft_optical_flow_tpu/ops/grid.py` (`coords_grid`,
`resize_bilinear_align_corners`, `upflow8`). NHWC in and out.
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, ht: int, wd: int, device="cuda",
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pixel-coordinate grid [batch, ht, wd, 2], channels (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=dtype, device=device),
        torch.arange(wd, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)[None].expand(batch, ht, wd, 2)


def _linspace_to(stop: float, num: int, device) -> torch.Tensor:
    """linspace(0, stop, num) in fp32 as the JAX package's compiled resize
    computes it: i * fl(stop * fl(1 / (num - 1))), the last point exactly
    stop. (XLA folds 0 * (1 - i/d) + stop * (i/d) into that product and
    turns the division into a product with the reciprocal; a one-ulp change
    of a position moves the resize by ulp * |hi - lo|.)"""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(num - 1, dtype=torch.float32)
    delta = torch.tensor(stop, dtype=torch.float32) * inv
    pos = torch.arange(num - 1, dtype=torch.float32, device=device) * delta.to(device)
    return torch.cat([pos, torch.full((1,), stop, dtype=torch.float32, device=device)])


def _interp_axis_align_corners(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """1-D linear interpolation along `axis` with the align_corners=True map.

    lo and hi, the two taps of each output position, come out of one product
    with a fixed one-hot [2*out, in] selection matrix (exact: one term per
    row is not zero), then lo * (1 - w) + hi * w. So the values are those of a
    gather, and the backward is a product too: no gather and no scatter, so
    no atomic adds and a gradient that is the same from run to run on the
    card. fp32 products with TF32 off, since TF32 would round the taps.
    """
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size == 1:
        reps = [1] * x.dim()
        reps[axis] = out_size
        return x.repeat(reps)
    pos = _linspace_to(in_size - 1.0, out_size, x.device)
    i0 = torch.floor(pos).clamp(0, in_size - 2)
    w = (pos - i0).to(x.dtype)
    cols = torch.arange(in_size, dtype=torch.float32, device=x.device)
    select = torch.cat([cols == i0[:, None], cols == i0[:, None] + 1]).to(x.dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        taps = torch.tensordot(select, x, dims=([1], [axis])).movedim(0, axis)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lo, hi = torch.split(taps, out_size, dim=axis)
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w.reshape(shape)
    return lo * (1 - w) + hi * w


def resize_bilinear_align_corners(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] with torch align_corners=True semantics."""
    out_h, out_w = out_hw
    img = _interp_axis_align_corners(img, out_h, img.dim() - 3)
    return _interp_axis_align_corners(img, out_w, img.dim() - 2)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """8x align-corners bilinear upsample of [N, h, w, 2] flow, values x8."""
    _, h, w, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, (8 * h, 8 * w))
