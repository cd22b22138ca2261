"""SimpleFlowNet's supervised loss: multi-scale EPE plus edge-aware
smoothness.

Counterpart of `raft_optical_flow_tpu/losses/simple_flow_loss.py`. Per
scale the GT is resized (half-pixel) and scaled by the width ratio; the
valid mask, (valid >= 0.5) & (|gt| < max_flow), takes the nearest resize;
the masked L2 EPE is averaged over ALL pixels (not over the valid ones: the
reference's quirk), with weights coarse-first (0.32, 0.08, 0.02); plus the
edge-aware smoothness e^-|grad I| * |grad F| of the finest prediction. NHWC
throughout; |x| takes JAX's gradient at 0 (`abs_jax`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from raft_optical_flow_tpu_torch.ops.grid import abs_jax, resize_bilinear, resize_nearest


def edge_aware_smoothness(flow: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
    """mean(e^-|dI/dx| |dF/dx|) + mean(e^-|dI/dy| |dF/dy|) of flow [N, h, w, 2]
    against the grey level of image [N, H, W, C] (resized to h x w first)."""
    if image.shape[1:3] != flow.shape[1:3]:
        image = resize_bilinear(image, flow.shape[1:3])
    gray = torch.mean(image, dim=-1, keepdim=True)
    wx = torch.exp(-abs_jax(gray[:, :, 1:] - gray[:, :, :-1]))
    wy = torch.exp(-abs_jax(gray[:, 1:] - gray[:, :-1]))
    return (torch.mean(wx * abs_jax(flow[:, :, 1:] - flow[:, :, :-1]))
            + torch.mean(wy * abs_jax(flow[:, 1:] - flow[:, :-1])))


def simple_flow_loss(
    flow_preds: Sequence[torch.Tensor],
    flow_gt: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    image: Optional[torch.Tensor] = None,
    weights: Sequence[float] = (0.32, 0.08, 0.02),
    edge_weight: float = 0.1,
    max_flow: float = 400.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: coarse-first, each [N, h, w, 2] in pixels at its own
    size; flow_gt [N, H, W, 2]; valid [N, H, W] or None; image [N, H, W, C]
    or None (no smoothness term). Returns (total, {"epe": the finest
    scale's masked EPE mean, "edge" (with an image), "total"})."""
    N, H, W, _ = flow_gt.shape
    base_valid = torch.sqrt(torch.sum(flow_gt**2, dim=-1)) < max_flow
    if valid is not None:
        base_valid = (valid >= 0.5) & base_valid
    valid_f = base_valid.to(flow_gt.dtype)[..., None]

    epe_loss = 0.0
    epe_last = None
    for i, pred in enumerate(flow_preds):
        w_i = weights[i] if i < len(weights) else weights[-1]
        h, w = pred.shape[1:3]
        scale = torch.tensor(w / W, dtype=flow_gt.dtype, device=flow_gt.device)
        gt_i = resize_bilinear(flow_gt, (h, w)) * scale
        v_i = resize_nearest(valid_f, (h, w))[..., 0]
        epe_last = torch.mean(torch.sqrt(torch.sum((pred - gt_i) ** 2, dim=-1)) * v_i)
        epe_loss = epe_loss + w_i * epe_last
    total = epe_loss

    metrics = {"epe": epe_last}
    if edge_weight > 0 and image is not None:
        edge = edge_aware_smoothness(flow_preds[-1], image)
        metrics["edge"] = edge
        total = total + edge_weight * edge
    metrics["total"] = total
    return total, metrics
