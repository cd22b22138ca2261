"""SimpleFlowNet's multi-scale unsupervised loss: photometric, edge-aware
smoothness and forward-backward consistency.

Counterpart of `raft_optical_flow_tpu/losses/unsupervised.py`. The warps
are `backward_warp` with zeros outside (the image resized to the flow's
size first); occlusion from forward-backward consistency,
|F_fw + warp(F_bw)| > 0.01 |F_fw| + 0.5; scale weights (0.32, 0.08, 0.02)
by position and term weights photometric 1.0, smoothness 0.1, consistency
0.1. NHWC throughout, flows (x, y) in pixels at each prediction's own size;
|x| takes JAX's gradient at 0 (`abs_jax`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from raft_optical_flow_tpu_torch.losses.simple_flow_loss import edge_aware_smoothness
from raft_optical_flow_tpu_torch.ops.grid import abs_jax, resize_bilinear
from raft_optical_flow_tpu_torch.ops.warp import backward_warp


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img [N, H, W, C] resized to flow's size, then backward-warped by it."""
    if img.shape[1:3] != flow.shape[1:3]:
        img = resize_bilinear(img, flow.shape[1:3])
    return backward_warp(img, flow, padding="zeros")


def photometric_loss(img1: torch.Tensor, img2: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Mean L1 between img1 and img2 warped by flow."""
    return torch.mean(abs_jax(img1 - warp_image(img2, flow)))


def occlusion_mask(flow_fw: torch.Tensor, flow_bw: torch.Tensor) -> torch.Tensor:
    """[N, h, w, 1]: 1 where visible, 0 where occluded."""
    flow_diff = flow_fw + warp_image(flow_bw, flow_fw)
    flow_mag = torch.sqrt(torch.sum(flow_fw**2, dim=-1, keepdim=True) + 1e-8)
    occ = torch.sqrt(torch.sum(flow_diff**2, dim=-1, keepdim=True)) > 0.01 * flow_mag + 0.5
    return (~occ).to(flow_fw.dtype)


def unsupervised_loss(
    img1: torch.Tensor,
    img2: torch.Tensor,
    flow_preds_fw: Sequence[torch.Tensor],
    flow_preds_bw: Optional[Sequence[torch.Tensor]] = None,
    alpha_photo: float = 1.0,
    alpha_smooth: float = 0.1,
    alpha_consist: float = 0.1,
    scale_weights: Sequence[float] = (0.32, 0.08, 0.02),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """img1, img2 [B, H, W, 3]; flow_preds_* one [B, h_i, w_i, 2] per scale
    (weights by position; equal weights when their count differs). Returns
    (total, {"total", "photometric", "smoothness", "consistency"})."""
    n = len(flow_preds_fw)
    weights = list(scale_weights) if len(scale_weights) == n else [1.0 / n] * n
    total_photo = total_smooth = total_consist = 0.0
    for i, (flow_fw, w) in enumerate(zip(flow_preds_fw, weights)):
        flow_bw = None
        if flow_preds_bw is not None and i < len(flow_preds_bw):
            flow_bw = flow_preds_bw[i]
        if flow_fw.shape[1:3] != img1.shape[1:3]:
            img1_s = resize_bilinear(img1, flow_fw.shape[1:3])
            img2_s = resize_bilinear(img2, flow_fw.shape[1:3])
        else:
            img1_s, img2_s = img1, img2

        photo = photometric_loss(img1_s, img2_s, flow_fw)
        smooth = edge_aware_smoothness(flow_fw, img1_s)
        if flow_bw is not None:
            photo = photo + photometric_loss(img2_s, img1_s, flow_bw)
            smooth = smooth + edge_aware_smoothness(flow_bw, img2_s)
            occ = occlusion_mask(flow_fw, flow_bw)
            consist = torch.mean(occ * abs_jax(flow_fw + warp_image(flow_bw, flow_fw)))
            total_consist = total_consist + w * consist
        total_photo = total_photo + w * photo
        total_smooth = total_smooth + w * smooth

    total = alpha_photo * total_photo + alpha_smooth * total_smooth + alpha_consist * total_consist
    return total, {"total": total, "photometric": total_photo, "smoothness": total_smooth,
                   "consistency": total_consist}
