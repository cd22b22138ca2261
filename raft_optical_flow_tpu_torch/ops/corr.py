"""All-pairs correlation volume, pyramid, and windowed lookup (plain PyTorch).

Counterpart of `raft_optical_flow_tpu/ops/corr.py`:

  - corr[b, q, u, v] = <fmap1[b, q], fmap2[b, u, v]> / sqrt(C), q row-major
    over frame-1 pixels; levels by 2x2 floor-mode average pooling;
  - the lookup samples a (2r+1)^2 bilinear window of corr_l[b, q] around
    coords / 2^l, zero for taps outside [0, Wl-1] x [0, Hl-1]. Window channel
    k = a*(2r+1) + b samples offset (dx, dy) = (a-r, b-r): trained weights
    depend on this order.

`sample_corr_window` and `corr_pyramid_lookup` are the plain versions of the
CUDA kernels in `kernels/corr_lookup.py`: the CPU path and the kernels' oracle.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over the last two dims of [..., H, W]; odd
    trailing rows and columns are dropped (floor mode)."""
    *lead, H, W = x.shape
    H2, W2 = H // 2, W // 2
    x = x[..., : 2 * H2, : 2 * W2].reshape(*lead, H2, 2, W2, 2)
    return x.mean(dim=(-3, -1))


def build_corr_pyramid_from_fmaps(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    num_levels: int = 4,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """One matmul per level against pooled fmap2 (pooling commutes with the
    dot product, so this equals pooling the volume).

    fmap1/fmap2: [B, H, W, C] fp32. dtype float32: full fp32 products and a
    fp32 volume. dtype bfloat16 (the mixed-precision policy): bf16 operands,
    fp32 accumulation, bf16 volume; the 1/sqrt(C) scale is applied to the
    bf16 product (exact when C is a power of 4, as C = 256 is).
    Returns levels of [B, H*W, Hl, Wl] in `dtype`.
    """
    B, H, W, C = fmap1.shape
    f1 = fmap1.reshape(B, H * W, C).float().to(dtype)
    scale = C**-0.5
    pyramid = []
    f2 = fmap2.float()
    for lvl in range(num_levels):
        Hl, Wl = f2.shape[1:3]
        corr = torch.matmul(f1, f2.reshape(B, Hl * Wl, C).to(dtype).transpose(1, 2))
        pyramid.append((corr * scale).reshape(B, H * W, Hl, Wl))
        if lvl + 1 < num_levels:
            f2 = avg_pool2x2(f2.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return tuple(pyramid)


def window_offsets(radius: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ox, oy), each [(2r+1)^2] fp32, in the channel order k = a*(2r+1)+b."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    K = d.numel()
    return d.repeat_interleave(K), d.repeat(K)


def sample_corr_window(
    corr_l: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, radius: int
) -> torch.Tensor:
    """Bilinear (2r+1)^2 window of corr_l around (cx, cy) per query.

    corr_l: [B, Q, Hl, Wl] fp32 or bf16; cx, cy: [B, Q] fp32 level-l centres.
    Returns [B, Q, (2r+1)^2] fp32 (fp32 weights and sums). Out-of-bounds taps
    and empty levels (Hl or Wl = 0) read 0.
    """
    B, Q, Hl, Wl = corr_l.shape
    ox, oy = window_offsets(radius, corr_l.device)
    K2 = ox.numel()
    if Hl == 0 or Wl == 0:
        return torch.zeros(B, Q, K2, dtype=torch.float32, device=corr_l.device)
    px = cx[..., None] + ox
    py = cy[..., None] + oy
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    # clamp before the int cast (a cast of a far out-of-range float is
    # undefined); [-2, W] keeps both x0 and x0+1 on the same side of the bounds
    x0i = x0.clamp(-2, Wl).long()
    y0i = y0.clamp(-2, Hl).long()
    flat = corr_l.reshape(B, Q, Hl * Wl)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= Wl - 1) & (yi >= 0) & (yi <= Hl - 1)
        idx = yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)
        v = torch.gather(flat, 2, idx).float()
        return torch.where(inb, v, torch.zeros((), device=v.device))

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def corr_pyramid_lookup(
    pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int
) -> torch.Tensor:
    """Multi-level windowed lookup.

    pyramid: [B, Q, Hl, Wl] per level; coords: [B, h, w, 2] level-0 (x, y),
    Q = h*w row-major. Returns [B, h, w, L*(2r+1)^2] fp32, levels
    concatenated coarse-last.
    """
    B, h, w, _ = coords.shape
    cx = coords[..., 0].reshape(B, h * w).float()
    cy = coords[..., 1].reshape(B, h * w).float()
    out = [
        sample_corr_window(c, cx * (1.0 / 2**lvl), cy * (1.0 / 2**lvl), radius)
        for lvl, c in enumerate(pyramid)
    ]
    return torch.cat(out, dim=-1).reshape(B, h, w, -1)
