"""Supervised flow losses: RAFT's sequence loss and LiteFlowNet3's
multi-scale loss.

Counterpart of `raft_optical_flow_tpu/losses/sequence.py`.
`sequence_loss`: gamma-weighted L1 over the GRU iterations; validity is
(valid >= 0.5) & (|gt| < max_flow); the mean runs over ALL pixels with the
invalid ones zeroed (not over the valid count: the reference RAFT's quirk,
kept); epe/1px/3px/5px over the valid pixels of the last prediction.
`multiscale_sequence_loss`: per-level L1 over the valid pixels, normalized
by their count. Inside `parallel.distributed.data_parallel` a count over
the batch is the global batch's (`distributed.batch_ratio`): each value is
this process's share, whose mean over the processes is the global value.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from raft_optical_flow_tpu_torch.ops.grid import resize_bilinear, resize_nearest
from raft_optical_flow_tpu_torch.parallel import distributed

MAX_FLOW = 400.0


def sequence_loss(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    gamma: float = 0.8,
    max_flow: float = MAX_FLOW,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds [T, N, H, W, 2], flow_gt [N, H, W, 2], valid [N, H, W] ->
    (scalar loss, {epe, 1px, 3px, 5px} scalars); iteration i weighs
    gamma^(T-i-1)."""
    T = flow_preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt**2, dim=-1))
    valid = (valid >= 0.5) & (mag < max_flow)
    vmask = valid[..., None].to(flow_preds.dtype)

    exps = torch.arange(T - 1, -1, -1, dtype=flow_preds.dtype, device=flow_preds.device)
    weights = torch.pow(torch.tensor(gamma, dtype=flow_preds.dtype, device=flow_preds.device), exps)
    i_loss = torch.abs(flow_preds - flow_gt[None])
    per_iter = torch.mean(vmask[None] * i_loss, dim=(1, 2, 3, 4))
    flow_loss = torch.sum(weights * per_iter)

    with torch.no_grad():
        epe = torch.sqrt(torch.sum((flow_preds[-1] - flow_gt) ** 2, dim=-1))
        vf = valid.to(epe.dtype)
        sums = torch.stack([torch.sum(epe * vf), torch.sum((epe < 1).to(epe.dtype) * vf),
                            torch.sum((epe < 3).to(epe.dtype) * vf),
                            torch.sum((epe < 5).to(epe.dtype) * vf)])
        ratios = distributed.batch_ratio(sums, vf.sum(), floor=1.0)
        metrics = dict(zip(("epe", "1px", "3px", "5px"), ratios))
    return flow_loss, metrics


def multiscale_sequence_loss(
    flow_preds: Sequence[torch.Tensor],
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    weights: Sequence[float] = (0.32, 0.08, 0.02, 0.01, 0.005),
    max_flow: float = MAX_FLOW,
) -> torch.Tensor:
    """Multi-scale L1 loss of the coarse-to-fine models (LiteFlowNet3).

    flow_preds: FINEST first, [N, h, w, 2] each (the full-size flow, then the
    pyramid levels, which the caller has multiplied by div_flow); flow_gt
    [N, H, W, 2], valid [N, H, W]. For a level smaller than the GT: the GT
    resized with half-pixel bilinear weights and scaled by w / W (both
    components, as the reference does), the valid mask resized nearest as
    the JAX package picks its rows (`ops/grid.py::resize_nearest`). Level i
    adds weights[i] (the last weight past the end) times the sum of the
    valid L1 over (valid count + 1e-8).
    """
    mag = torch.sqrt(torch.sum(flow_gt**2, dim=-1))
    valid_f = ((valid >= 0.5) & (mag < max_flow)).to(flow_gt.dtype)[..., None]
    H, W = flow_gt.shape[1:3]
    total = 0.0
    for i, pred in enumerate(flow_preds):
        w_i = weights[i] if i < len(weights) else weights[-1]
        h, wd = pred.shape[1:3]
        if (h, wd) != (H, W):
            scale = torch.tensor(wd / W, dtype=flow_gt.dtype)
            gt_i = resize_bilinear(flow_gt, (h, wd)) * scale.to(flow_gt.device)
            v_i = (resize_nearest(valid_f, (h, wd)) > 0.5).to(flow_gt.dtype)
        else:
            gt_i, v_i = flow_gt, valid_f
        l1 = torch.abs(pred - gt_i)
        total = total + distributed.batch_ratio(w_i * torch.sum(v_i * l1), torch.sum(v_i), 1e-8)
    return total
