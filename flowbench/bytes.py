"""Bytes the lookup kernels must move, from their inputs.

Each input byte read once and each output byte written once:

  - K1 (`lookup_level_kernel`, one level): each query's coordinates (8 B),
    the in-bounds part of its (2r+2)^2 patch of the level (the bilinear
    window's support), and its (2r+1)^2 outputs;
  - K2 (`coarse_fused_kernel`, levels 1..L-1 in one launch): the coordinates
    once, and per level the in-bounds patch and the outputs;
  - K3 (`lookup_level_bwd_kernel`, K1's volume gradient at one level): the
    dense gradient of the level written once, the window cotangent and the
    coordinates read once.

The patch count depends on where the windows fall, so it is taken from the
coordinates the lookup received. A frozen copy of the counting that
`chip_smoke.py` phase `timing` uses for its bounds.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from flowbench.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

OPS_PER_OUTPUT = 17  # fp32 operations of one bilinear window output (K1, K2)
OPS_PER_PATCH_ELEMENT = 12  # at most four taps of three fp32 operations (K3)


def patch_bytes(coords_l: torch.Tensor, Hl: int, Wl: int, radius: int, itemsize: int) -> float:
    """In-bounds (2r+2)^2 patch bytes of every query; coords_l [..., 2] at the
    level's scale."""
    K = 2 * radius + 1
    x0 = torch.floor(coords_l[..., 0].float()) - radius
    y0 = torch.floor(coords_l[..., 1].float()) - radius
    nx = (torch.clamp(x0 + K, max=Wl - 1) - torch.clamp(x0, min=0) + 1).clamp(min=0)
    ny = (torch.clamp(y0 + K, max=Hl - 1) - torch.clamp(y0, min=0) + 1).clamp(min=0)
    return float((nx * ny).sum()) * itemsize


def k1_bytes(coords: torch.Tensor, level: int, hw: Tuple[int, int], radius: int,
             vol_itemsize: int, out_itemsize: int) -> float:
    """coords [B, Q, 2] at level 0."""
    n = coords.shape[0] * coords.shape[1]
    K = 2 * radius + 1
    c = coords * (1.0 / 2 ** level)
    return n * 8 + patch_bytes(c, hw[0], hw[1], radius, vol_itemsize) + n * K * K * out_itemsize


def k2_bytes(coords: torch.Tensor, levels_hw: Sequence[Tuple[int, int]], radius: int,
             vol_itemsize: int, out_itemsize: int) -> float:
    """levels_hw: the shapes of levels 1..L-1."""
    n = coords.shape[0] * coords.shape[1]
    K = 2 * radius + 1
    total = n * 8
    for lvl, (hl, wl) in enumerate(levels_hw, start=1):
        c = coords * (1.0 / 2 ** lvl)
        total += patch_bytes(c, hl, wl, radius, vol_itemsize) + n * K * K * out_itemsize
    return total


def k3_bytes(n_queries: int, hw: Tuple[int, int], radius: int, vol_itemsize: int,
             g_itemsize: int) -> float:
    K = 2 * radius + 1
    return n_queries * (hw[0] * hw[1] * vol_itemsize + K * K * g_itemsize + 8)


def level_shapes(h: int, w: int, levels: int):
    out = [(h, w)]
    for _ in range(levels - 1):
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out


def bound_s(nbytes: float, ops: float) -> float:
    """The least time of a launch: its bytes at HBM rate or its operations
    at the fp32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)


def coords_from_flow(flow_nchw: torch.Tensor) -> torch.Tensor:
    """Level-0 lookup centres [B, Q, 2], the grid plus the update block's
    flow input [B, 2, h, w] (that flow is the centres less the grid, in the
    compute dtype)."""
    B, _, h, w = flow_nchw.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow_nchw.device, dtype=torch.float32),
                            torch.arange(w, device=flow_nchw.device, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([xs, ys], 0)[None]
    return (grid + flow_nchw.float()).permute(0, 2, 3, 1).reshape(B, h * w, 2)


def serve_bound_s(flows, levels: int, radius: int, itemsize: int) -> float:
    """Least time of one serving iteration's K1 and K2 launches, summed over
    the iterations whose update-block flow inputs are `flows`."""
    total = 0.0
    K2 = (2 * radius + 1) ** 2
    for f in flows:
        c = coords_from_flow(f)
        n = c.shape[0] * c.shape[1]
        shapes = level_shapes(f.shape[2], f.shape[3], levels)
        total += bound_s(k1_bytes(c, 0, shapes[0], radius, itemsize, itemsize),
                         n * K2 * OPS_PER_OUTPUT)
        total += bound_s(k2_bytes(c, shapes[1:], radius, itemsize, itemsize),
                         n * K2 * (levels - 1) * OPS_PER_OUTPUT)
    return total


def train_bound_s(flows, levels: int, radius: int, itemsize: int) -> float:
    """Least time of one training iteration's K1 and K3 launches (one of
    each per level), summed over the iterations."""
    total = 0.0
    K2 = (2 * radius + 1) ** 2
    for f in flows:
        c = coords_from_flow(f)
        n = c.shape[0] * c.shape[1]
        for lvl, hw in enumerate(level_shapes(f.shape[2], f.shape[3], levels)):
            total += bound_s(k1_bytes(c, lvl, hw, radius, itemsize, itemsize),
                             n * K2 * OPS_PER_OUTPUT)
            patch = patch_bytes(c * (1.0 / 2 ** lvl), hw[0], hw[1], radius, 1)
            total += bound_s(k3_bytes(n, hw, radius, itemsize, itemsize),
                             patch * OPS_PER_PATCH_ELEMENT)
    return total
