"""Windowed local correlation of two feature maps (the reference's
`spatial-correlation-sampler` op), LiteFlowNet3's cost volumes.

Counterpart of `spatial_correlation_sample` and
`translated_spatial_correlation_sample` in
`raft_optical_flow_tpu/ops/spatial_corr.py`. NHWC at the surface; NHWC views of
contiguous NCHW tensors go in and come out without a copy. Channel k = pi * patch + pj for the offset
(dy, dx) = ((pi - patch//2) * dilation, (pj - patch//2) * dilation): y-major,
unlike RAFT's x-major window. Sums over C run in fp32 and round once to the
feature dtype; offsets outside the map contribute zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import bilinear_sampler, coords_grid, widen


def spatial_correlation_sample(in1: torch.Tensor, in2: torch.Tensor, patch_size: int,
                               dilation_patch: int = 1) -> torch.Tensor:
    """Correlation of in1 with in2 over a (patch x patch) window of offsets.

    in1, in2: [B, H, W, C]. Returns [B, H, W, patch^2] in in1's dtype, NOT
    normalized (LiteFlowNet3 divides by C). One shifted product and channel
    sum per offset: no unfolded copy of in2, whose patch^2-fold size would
    not fit at serving shapes.
    """
    B, H, W, C = in1.shape
    p, d = patch_size, dilation_patch
    lo, hi = d * ((p - 1) // 2), d * (p // 2)
    a = widen(in1.permute(0, 3, 1, 2))
    b = widen(F.pad(in2.permute(0, 3, 1, 2), (lo, hi, lo, hi)))
    outs = [(a * b[:, :, pi * d:pi * d + H, pj * d:pj * d + W]).sum(dim=1)
            for pi in range(p) for pj in range(p)]
    return torch.stack(outs, dim=1).to(in1.dtype).permute(0, 2, 3, 1)



def translated_spatial_correlation_sample(in1: torch.Tensor, in2: torch.Tensor,
                                          flow: torch.Tensor, patch_size: int,
                                          dilation_patch: int = 1) -> torch.Tensor:
    """Correlation of in1 with in2 sampled around grid + flow, without
    warping in2 first (`liteflownet3_correlation.py:222-349`).

    in1, in2: [B, H, W, C]; flow: [B, H, W, 2] pixels (x, y). Channel
    k = pi * patch + pj samples in2 bilinearly (zeros outside) at grid +
    flow + (dx, dy) = (dil * (pj - half), dil * (pi - half)), half =
    (patch - 1) // 2: y-major. Returns [B, H, W, patch^2] in in1's dtype,
    NOT normalized; the sum over C runs in fp32 and rounds once.
    """
    B, H, W, C = in1.shape
    p = patch_size
    offs = dilation_patch * (torch.arange(p, dtype=torch.float32, device=in1.device)
                             - (p - 1) // 2)
    oy, ox = offs.repeat_interleave(p), offs.repeat(p)  # y-major
    coords = coords_grid(B, H, W, device=in1.device) + flow
    pts = torch.stack([coords[..., 0:1] + ox, coords[..., 1:2] + oy], dim=-1)
    sampled = bilinear_sampler(in2, pts)  # [B, H, W, p^2, C]
    out = torch.einsum("bhwc,bhwkc->bhwk", widen(in1), widen(sampled))
    return out.to(in1.dtype)
