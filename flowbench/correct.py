"""The numbers that decide `correct`, from the program's outputs and the
reference's.

Serving (flows in pixels, the timed calls' outputs against the reference's
on the same inputs and weights):
  - `flow_up_epe_mean`: the mean end-point error of the unpadded flow_up;
  - `flow_up_epe_max`: its largest end-point error;
  - `flow_low_epe_max`: the largest end-point error of flow_low.

Training (the first three steps, each leaf a parameter of the model):
  - `loss_rel`: the largest relative gap of a step's loss;
  - `grad_norm_rel`: the largest relative gap of a step's global gradient
    norm before the clip;
  - `first_grad_rel`: over the leaves, the gap between the norms of the
    first step's clipped gradient, over the larger of the reference's norm
    of that leaf and of the median leaf;
  - `change_rel`: the same for the parameters' change over three steps,
    leaving out the leaves whose reference gradient is under a thousandth of
    the median leaf's (their change under Adam is round-off alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch


def epe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a.float() - b.float(), dim=-1)


def serve_numbers(pairs: Sequence) -> Dict[str, float]:
    """pairs: (program (flow_low, flow_up), reference (flow_low, flow_up)) per
    compared call, on one device."""
    means, up_max, low_max = [], [], []
    for (p_lo, p_up), (r_lo, r_up) in pairs:
        e = epe(p_up, r_up)
        means.append(float(e.mean()))
        up_max.append(float(e.max()))
        low_max.append(float(epe(p_lo, r_lo).max()))
    return {"flow_up_epe_mean": sum(means) / len(means), "flow_up_epe_max": max(up_max),
            "flow_low_epe_max": max(low_max)}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog, ref: {"loss": [3], "grad_norm": [3], "first_grad": {leaf: norm},
    "change": {leaf: norm}}."""
    leaves = sorted(ref["first_grad"])
    median_g = statistics.median(ref["first_grad"][k] for k in leaves)
    moved = [k for k in leaves if ref["first_grad"][k] >= 1e-3 * median_g]
    return {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_norm_rel": max(abs(a - b) / abs(b)
                             for a, b in zip(prog["grad_norm"], ref["grad_norm"])),
        "first_grad_rel": _worst_leaf(prog["first_grad"], ref["first_grad"], leaves),
        "change_rel": _worst_leaf(prog["change"], ref["change"], moved),
    }
