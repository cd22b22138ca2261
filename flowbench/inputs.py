"""Seeded frame pairs, made on the device.

Frame 1 is smoothed noise in [0, 255]: three octaves of uniform noise (a
1/32, a 1/8 and a full-resolution grid), each upsampled bilinearly and
weighted 0.5, 0.35 and 0.15. Frame 2 is frame 1 displaced by a smooth random
field: a 4 x 8 grid of displacements uniform in +-`max_disp` pixels, upsampled
bilinearly (align corners) to the frame, and frame 2 at p samples frame 1 at
p - flow(p) (bilinear, border). For training that field is the ground truth
and `valid` is all ones.

Every draw comes from one generator on the device, seeded by (seed, index):
the same seed gives the same batches on any run.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

MAX_DISP = 8.0


def _octave(n: int, h: int, w: int, H: int, W: int, gen, device) -> torch.Tensor:
    u = torch.rand(n, 3, h, w, generator=gen, device=device)
    return F.interpolate(u, size=(H, W), mode="bilinear", align_corners=False)


def make_batch(seed: int, index: int, n: int, H: int, W: int, device,
               max_disp: float = MAX_DISP) -> Dict[str, torch.Tensor]:
    """Batch `index` of the seed: image1, image2 [n, H, W, 3] fp32 in
    [0, 255], flow [n, H, W, 2] (x, y), valid [n, H, W]."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 1000003 + index) % (2**63))
    tex = (0.5 * _octave(n, max(H // 32, 2), max(W // 32, 2), H, W, gen, device)
           + 0.35 * _octave(n, max(H // 8, 2), max(W // 8, 2), H, W, gen, device)
           + 0.15 * torch.rand(n, 3, H, W, generator=gen, device=device))
    img1 = (tex * 255.0).clamp(0.0, 255.0)
    d = (torch.rand(n, 2, 4, 8, generator=gen, device=device) * 2.0 - 1.0) * max_disp
    flow = F.interpolate(d, size=(H, W), mode="bilinear", align_corners=True)
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    sx = (xs - flow[:, 0]) * (2.0 / max(W - 1, 1)) - 1.0
    sy = (ys - flow[:, 1]) * (2.0 / max(H - 1, 1)) - 1.0
    img2 = F.grid_sample(img1, torch.stack([sx, sy], -1), mode="bilinear",
                         padding_mode="border", align_corners=True)
    nhwc = lambda x: x.permute(0, 2, 3, 1).contiguous()  # noqa: E731
    return {"image1": nhwc(img1), "image2": nhwc(img2), "flow": nhwc(flow),
            "valid": torch.ones(n, H, W, device=device)}
