"""RAFT's supervised sequence loss.

Counterpart of `raft_optical_flow_tpu/losses/sequence.py::sequence_loss`:
gamma-weighted L1 over the GRU iterations; validity is
(valid >= 0.5) & (|gt| < max_flow); the mean runs over ALL pixels with the
invalid ones zeroed (not over the valid count: the reference RAFT's quirk,
kept); epe/1px/3px/5px over the valid pixels of the last prediction.
`multiscale_sequence_loss` (LiteFlowNet3) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

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
        denom = torch.clamp(vf.sum(), min=1.0)
        metrics = {
            "epe": torch.sum(epe * vf) / denom,
            "1px": torch.sum((epe < 1).to(epe.dtype) * vf) / denom,
            "3px": torch.sum((epe < 3).to(epe.dtype) * vf) / denom,
            "5px": torch.sum((epe < 5).to(epe.dtype) * vf) / denom,
        }
    return flow_loss, metrics
