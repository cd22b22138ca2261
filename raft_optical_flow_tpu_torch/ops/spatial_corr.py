"""Windowed local correlation of two feature maps (the reference's
`spatial-correlation-sampler` op), LiteFlowNet3's cost volumes.

Counterpart of `spatial_correlation_sample` in
`raft_optical_flow_tpu/ops/spatial_corr.py` (its translated variant has no
caller in the model and is not ported). NHWC at the surface; NHWC views of
contiguous NCHW tensors go in and come out without a copy. Channel k = pi * patch + pj for the offset
(dy, dx) = ((pi - patch//2) * dilation, (pj - patch//2) * dilation): y-major,
unlike RAFT's x-major window. Sums over C run in fp32 and round once to the
feature dtype; offsets outside the map contribute zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import widen


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

