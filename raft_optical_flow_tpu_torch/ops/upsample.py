"""Learned convex 8x flow upsampling (RAFT's `upsample_flow`).

Counterpart of `raft_optical_flow_tpu/ops/upsample.py`: the mask channel
c = (k*f + sy)*f + sx, k the 3x3-neighbour index (row-major, (dy, dx) =
(ky-1, kx-1)); softmax over the 9 neighbours; exact fp32 broadcast-sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted_neighbors_3x3(x: torch.Tensor) -> torch.Tensor:
    """All 3x3 neighbourhoods of NHWC x as [N, h, w, 9, C], zero padded."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, ky : ky + h, kx : kx + w, :] for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=3)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int = 8) -> torch.Tensor:
    """flow: [N, h, w, 2]; mask: [N, h, w, 9*f*f] raw weights -> [N, f*h, f*w, 2] fp32."""
    N, h, w, _ = flow.shape
    f = factor
    m = torch.softmax(mask.float().reshape(N, h, w, 9, f * f), dim=3)
    nbrs = _shifted_neighbors_3x3(float(f) * flow.float())  # [N, h, w, 9, 2]
    up = torch.sum(m[..., None] * nbrs[:, :, :, :, None, :], dim=3)  # [N, h, w, f*f, 2]
    up = up.reshape(N, h, w, f, f, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(N, f * h, f * w, 2)
