"""Per-layer gradient comparisons of a train step, as `chip_smoke.py` and the
card's tests hold the card against the port on the CPU, and the port's
kernels against their plain versions.

  - `layer_max_rel`: a layer's reading, max|d| / max|ref| over its weight
    and bias together, so that each layer is held on its own scale.
  - `gradient_gate`: the bound of each layer, max(2e-5, 2x the spread of
    the card's step run twice (atomic adds in PyTorch's backward of the
    gathers and resizes), 2x a measured floor where one is given). A
    floor is what rounding alone moves that layer by on these inputs,
    measured on the reference side: the CPU fp32 error against the port
    in float64 (phase lfn3), or the reference step against itself with
    every weight changed by one ulp (`nudge_weights`; RAFT-small's UFlow
    step, whose gradients are ill-conditioned). A layer that fp32 cannot
    hold to 2e-5 widens its own gate, and no other.
  - `flow_step`: one `FlowTrainer` step's metrics and gradients.
  - `uflow_check_batch`: the UFlow step's small batch, 48x64 crops of the
    RAFT-small golden's real frames.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

GRAD_GATE = 2e-5


def layer_max_rel(grads: Mapping[str, torch.Tensor],
                  ref: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """max|d| / max|ref| for each layer (the name up to its last dot). A
    layer whose reference gradient is zero (one the step does not reach)
    reads 0.0 when the other is zero too, else inf."""
    diff: Dict[str, float] = {}
    scale: Dict[str, float] = {}
    for k, r in ref.items():
        layer = k.rsplit(".", 1)[0]
        g, r = torch.as_tensor(grads[k]).double(), torch.as_tensor(r).double()
        diff[layer] = max(diff.get(layer, 0.0), float((g.cpu() - r.cpu()).abs().max()))
        scale[layer] = max(scale.get(layer, 0.0), float(r.abs().max()))
    return {n: diff[n] / scale[n] if scale[n] else (0.0 if diff[n] == 0 else math.inf)
            for n in scale}


def gradient_gate(spread: Mapping[str, float],
                  floor: Optional[Mapping[str, float]] = None) -> Dict[str, float]:
    """Each layer's bound: max(2e-5, 2x spread[layer], 2x floor[layer])."""
    return {n: max(GRAD_GATE, 2 * s, 2 * floor[n] if floor is not None else 0.0)
            for n, s in spread.items()}


def nudge_weights(model: torch.nn.Module, seed: int = 1) -> None:
    """Every weight times (1 +- 1e-7), the sign drawn from `seed`: about one
    ulp, the change whose effect on the gradients is the step's rounding
    floor (ROADMAP.md's rule for gradient comparisons)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g).to(p.device) * 2.0 - 1.0
            p.mul_(1 + 1e-7 * sign)


def flow_step(trainer, batch, step: int = 0):
    """One `trainer.train_step(batch)` from train-state step `step`: (its
    metrics as floats, {parameter name: gradient on the CPU})."""
    trainer.state.step = step
    metrics = trainer.train_step(batch)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()})


def uflow_check_batch(repo: str, H: int = 48, W: int = 64) -> Dict[str, np.ndarray]:
    """Two HxW crops of `tests/goldens/raft_small.npz`'s 192x320 frames
    (0-255, fp32) and a seeded flow for the monitoring EPE."""
    g = np.load(os.path.join(repo, "tests", "goldens", "raft_small.npz"))
    corners = ((20, 30), (100, 200))

    def crop(img):
        return np.stack([img[y:y + H, x:x + W] for y, x in corners]).astype(np.float32)

    flow = np.random.RandomState(7).uniform(-3, 3, (2, H, W, 2)).astype(np.float32)
    return {"image1": crop(g["image1"]), "image2": crop(g["image2"]), "flow": flow}
