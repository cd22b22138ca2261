"""Laplacian-pyramid reconstruction loss (RIFE's LapLoss), IFNet's
unsupervised loss.

Counterpart of `raft_optical_flow_tpu/losses/laploss.py`: a 5x5 binomial
blur (sum 256) with reflect padding, stride-2 decimation, a zero-insert
upsample blurred again with 4x the kernel, per-level L1 means. NHWC at the
surface. The blur is a depthwise fp32 `F.conv2d` with TF32 off; the
zero-insert upsample is a strided assignment (its gradient a strided read,
no scatter); |x| takes JAX's gradient at 0 (`abs_jax`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.ops.grid import abs_jax

_KERNEL_1D = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0])
_KERNEL = torch.outer(_KERNEL_1D, _KERNEL_1D) / 256.0  # [5, 5]


def _conv_gauss(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 5x5 blur of NCHW x with reflect padding."""
    C = x.shape[1]
    k = kernel.to(device=x.device, dtype=x.dtype).expand(C, 1, 5, 5)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), k, groups=C)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-insert 2x upsample, then the blur with 4x the kernel."""
    N, C, H, W = x.shape
    up = x.new_zeros(N, C, 2 * H, 2 * W)
    up[:, :, ::2, ::2] = x
    return _conv_gauss(up, 4.0 * _KERNEL)


def _check_sizes(H: int, W: int, max_levels: int) -> None:
    """The reflect pad of 2 needs a side longer than 2 at every level
    (`jnp.pad` reflects again where torch raises)."""
    for level in range(max_levels):
        if H <= 2 or W <= 2:
            raise ValueError(f"laploss needs every pyramid level over 2x2 pixels: level {level} "
                             f"of a {max_levels}-level pyramid is {H}x{W}")
        H, W = (H + 1) // 2, (W + 1) // 2


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 5) -> List[torch.Tensor]:
    """The Laplacian pyramid of img [N, H, W, C]: max_levels NHWC levels,
    finest first."""
    _check_sizes(img.shape[1], img.shape[2], max_levels)
    current = img.permute(0, 3, 1, 2)
    pyr = []
    for _ in range(max_levels):
        down = _conv_gauss(current, _KERNEL)[:, :, ::2, ::2]
        pyr.append((current - _upsample(down)).permute(0, 2, 3, 1))
        current = down
    return pyr


def lap_loss(input: torch.Tensor, target: torch.Tensor, max_levels: int = 5) -> torch.Tensor:
    """Sum over the levels of the L1 mean between the two pyramids."""
    pi = laplacian_pyramid(input, max_levels)
    pt = laplacian_pyramid(target, max_levels)
    return sum(torch.mean(abs_jax(a - b)) for a, b in zip(pi, pt))


def laploss(
    warped_list: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    img0: torch.Tensor,
    img1: torch.Tensor,
    max_levels: int = 5,
):
    """IFNet's unsupervised loss over every block of the cascade: each
    warped_img1 against img0 and each warped_img0 against img1 (the
    reference's pairing). Returns (loss, {"epe": the last block's
    photometric L1, a proxy})."""
    loss = 0.0
    for warp0, warp1 in warped_list:
        loss = loss + lap_loss(warp1, img0, max_levels)
        loss = loss + lap_loss(warp0, img1, max_levels)
    epe = (torch.mean(torch.abs(warped_list[-1][1] - img0))
           + torch.mean(torch.abs(warped_list[-1][0] - img1))) / 2.0
    return loss, {"epe": epe}
