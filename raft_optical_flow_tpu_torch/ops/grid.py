"""Coordinate grids, bilinear sampling and resizes.

Counterpart of `raft_optical_flow_tpu/ops/grid.py` (`coords_grid`,
`bilinear_sampler` with its in-bounds mask, `grid_sample_nearest`,
`resize_bilinear_align_corners`, `resize_bilinear`, `upflow8`, `upflow_n`),
plus `resize_nearest`, the nearest resize of `jax.image.resize`, `abs_jax`
and `clip_jax`, `jnp.abs` and `jnp.clip` with JAX's gradients where torch's
differ, `widen`, the fp32 (or float64) carry dtype, and `no_tf32`. NHWC
in and out. A tensor given as an NHWC view of a contiguous NCHW tensor
(`x.permute(0, 2, 3, 1)`) goes through `bilinear_sampler` and
`resize_bilinear` without a copy, and what they return is such a view
again: the models call them from NCHW code.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """cuBLAS fp32 products in full fp32 inside the block (TF32 off), the
    JAX package's Precision.HIGHEST; the old setting after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def coords_grid(batch: int, ht: int, wd: int, device="cuda",
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pixel-coordinate grid [batch, ht, wd, 2], channels (x, y)."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=dtype, device=device),
        torch.arange(wd, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)[None].expand(batch, ht, wd, 2)


def _bilinear_taps(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   padding: str) -> torch.Tensor:
    """Bilinear samples of NCHW img at pixel positions x, y [N, Q]: [N, C, Q].

    Four gathers at the floor's corners, each at its index clamped into the
    image; under "zeros" padding a tap outside the image is zero. The JAX
    package's form for images under 2 pixels high or wide.
    """
    N, C, H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0).to(img.dtype)[:, None]
    wy = (y - y0).to(img.dtype)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    flat = img.reshape(N, C, H * W)

    def tap(xi, yi):
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = torch.gather(flat, 2, idx[:, None].expand(N, C, idx.shape[1]))
        if padding == "border":
            return v
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        return torch.where(inb[:, None], v, torch.zeros((), dtype=img.dtype, device=img.device))

    return (tap(x0i, y0i) * (1 - wy) * (1 - wx) + tap(x0i + 1, y0i) * (1 - wy) * wx
            + tap(x0i, y0i + 1) * wy * (1 - wx) + tap(x0i + 1, y0i + 1) * wy * wx)


def widen(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in float64 when it is float64: the dtype of the values
    the policies carry in fp32 (flows, warp coordinates, correlation sums),
    so that a float64 run (a CPU yardstick for gradients) stays float64."""
    return x if x.dtype == torch.float64 else x.float()


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with `jnp.abs`'s gradient, +1 at 0 (`torch.abs`'s is 0)."""
    return torch.where(x >= 0, x, -x)


def clip_jax(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`: the same values as `torch.clamp`, and JAX's
    gradient at a bound, 0.5 (`torch.clamp`'s is 1). `torch.maximum` and
    `torch.minimum` split the gradient at a tie as `jnp.maximum` does."""
    x = torch.maximum(x, x.new_tensor(lo))
    return torch.minimum(x, x.new_tensor(hi))


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     padding: str = "zeros", return_mask: bool = False):
    """Bilinear samples of img [N, H, W, C] at pixel coords [N, *S, 2] (x, y),
    torch `grid_sample(align_corners=True)` semantics: (0, 0) is the centre
    of the top-left pixel. Returns [N, *S, C]. `padding` "zeros": taps
    outside the image contribute zero; "border": x is clipped to [0, W-1]
    and y to [0, H-1] first (`clip_jax`, JAX's gradient at the bounds).
    With `return_mask`, also the mask [N, *S] in img's dtype of positions
    strictly inside the image, 0 < x < W-1 and 0 < y < H-1 (the reference's
    open interval; after the clip under "border").

    The JAX package's sampler. The taps and
    weights are JAX's, in pixel coordinates: the 2x2 patch at the root
    clip(floor(p), 0, size-2), each tap weighted by the hat
    max(1 - |p - tap|, 0), which is zero for a tap the position is a pixel
    or more away from (so outside taps never count). The four weights are
    rounded to img's dtype, as the JAX package does under the bf16 policy.
    At the kinks (a position on a pixel) the gradient takes JAX's one-sided
    choices. Four gathers, no normalisation to [-1, 1]: a one-ulp position
    error of that normalisation is 6e-5 px at W = 1024.
    """
    if padding not in ("zeros", "border"):
        raise ValueError(f"unknown padding mode {padding!r}")
    N, H, W, C = img.shape
    S = coords.shape[1:-1]
    x = coords[..., 0].reshape(N, -1)
    y = coords[..., 1].reshape(N, -1)
    if padding == "border":
        x = clip_jax(x, 0.0, W - 1.0)
        y = clip_jax(y, 0.0, H - 1.0)
    nchw = img.permute(0, 3, 1, 2)
    if H < 2 or W < 2:
        out = _bilinear_taps(nchw, x, y, padding)
    else:
        x0 = torch.clamp(torch.floor(x), 0.0, W - 2.0)
        y0 = torch.clamp(torch.floor(y), 0.0, H - 2.0)

        def hat(p, t):
            d = abs_jax(p - t)
            return torch.maximum(1.0 - d, d.new_zeros(())).to(img.dtype)[:, None]

        wy0, wy1 = hat(y, y0), hat(y, y0 + 1.0)
        wx0, wx1 = hat(x, x0), hat(x, x0 + 1.0)
        root = y0.long() * W + x0.long()
        flat = nchw.reshape(N, C, H * W)

        def tap(off):
            idx = (root + off)[:, None].expand(N, C, root.shape[1])
            return torch.gather(flat, 2, idx)

        out = (tap(0) * (wy0 * wx0) + tap(1) * (wy0 * wx1)
               + tap(W) * (wy1 * wx0) + tap(W + 1) * (wy1 * wx1))
    out = out.reshape(N, C, *S).movedim(1, -1)
    if return_mask:
        mask = (x > 0) & (x < W - 1) & (y > 0) & (y < H - 1)
        return out, mask.to(img.dtype).reshape(N, *S)
    return out


def grid_sample_nearest(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [N, H, W, C] at the nearest pixel of coords [N, *S, 2] (x, y), the
    position clamped into the image: [N, *S, C]. `torch.round` rounds half
    to even, as `jnp.round` does (floor(x + 0.5) would not)."""
    N, H, W, C = img.shape
    S = coords.shape[1:-1]
    # clamp in float before the int cast (a cast of a far out-of-range float is undefined)
    xi = torch.round(coords[..., 0].reshape(N, -1)).clamp(0, W - 1).long()
    yi = torch.round(coords[..., 1].reshape(N, -1)).clamp(0, H - 1).long()
    idx = (yi * W + xi)[..., None].expand(N, xi.shape[1], C)
    return torch.gather(img.reshape(N, H * W, C), 1, idx).reshape(N, *S, C)


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
    with no_tf32():
        taps = torch.tensordot(select, x, dims=([1], [axis])).movedim(0, axis)
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


def upflow_n(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """factor-x align-corners bilinear upsample of [N, h, w, 2] flow, values x factor."""
    _, h, w, _ = flow.shape
    return float(factor) * resize_bilinear_align_corners(flow, (factor * h, factor * w))


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] with half-pixel centres (torch
    `align_corners=False`, no antialiasing), the JAX package's
    `jax.image.resize(method="bilinear", antialias=False)`. JAX computes a
    weighted sum and torch interpolates, so the two round differently: equal
    within a few ulp, not bit for bit."""
    *lead, H, W, C = img.shape
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(*lead, *out_hw, C)


def nearest_indices(in_size: int, out_size: int, device="cuda") -> torch.Tensor:
    """The source rows of a nearest resize from in_size to out_size, as the
    JAX package's compiled `jax.image.resize(method="nearest")` picks them:
    floor((i + 0.5) * fl(in * fl(1 / out))) in fp32. XLA folds
    (i + 0.5) * in / out into that product; neither the exact quotient nor
    torch's 'nearest' or 'nearest-exact' picks the same rows at every size
    (at 436 -> 109 both differ in every row)."""
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(out_size, dtype=torch.float32)
    scale = torch.tensor(in_size, dtype=torch.float32) * inv
    pos = (torch.arange(out_size, dtype=torch.float32) + 0.5) * scale
    return torch.floor(pos).long().to(device)


def resize_nearest(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of [..., H, W, C] to out_hw, `nearest_indices` rows and
    columns: the JAX package's `jax.image.resize(method="nearest")`."""
    H, W = img.shape[-3], img.shape[-2]
    out_h, out_w = out_hw
    if out_h != H:
        img = img.index_select(img.dim() - 3, nearest_indices(H, out_h, img.device))
    if out_w != W:
        img = img.index_select(img.dim() - 2, nearest_indices(W, out_w, img.device))
    return img
