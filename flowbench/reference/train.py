"""RAFT's training step in plain PyTorch: the sequence loss, the global-norm
clip and `torch.optim.AdamW` under the reference's one-cycle schedule.

As github.com/princeton-vl/RAFT `train.py` trains: the loss weighs iteration
i of T by gamma^(T-i-1) and takes the L1 mean over every pixel with the
invalid ones zeroed (pixels with valid < 0.5 or |flow| >= 400); the
gradients are clipped to a global norm of `clip` (scaled by clip/norm when
the norm is not below clip); AdamW steps with decoupled weight decay; the
learning rate is the linear one-cycle schedule (pct_start 0.05 of
num_steps + 100, div 25, final div 1e4), read at the update count before the
update.

The global batch may be run in blocks of rows (`rows`): each block's loss
is scaled by its share of the batch and the gradients add up, so the step is
the whole batch's, in the memory of one block.

Imports torch and `flowbench.reference.raft` only.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from flowbench.reference.raft import PlainRAFT

MAX_FLOW = 400.0


def sequence_loss(preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float) -> torch.Tensor:
    """preds [T, N, H, W, 2], flow_gt [N, H, W, 2], valid [N, H, W] -> loss."""
    T = preds.shape[0]
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=-1))
    vmask = ((valid >= 0.5) & (mag < MAX_FLOW))[..., None].to(preds.dtype)
    weights = gamma ** torch.arange(T - 1, -1, -1, dtype=preds.dtype, device=preds.device)
    per_iter = torch.mean(vmask[None] * torch.abs(preds - flow_gt[None]), dim=(1, 2, 3, 4))
    return torch.sum(weights * per_iter)


def onecycle_lr(count: int, lr: float, num_steps: int) -> float:
    """The learning rate of update `count` (0 for the first): linear from
    lr/25 to lr over the first 5% of num_steps + 100 updates, then linear
    down to lr * 1e-4 at num_steps + 100, constant after."""
    total = num_steps + 100
    bounds, values = (0, int(0.05 * total), total), (lr / 25.0, lr, lr * 1e-4)
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            return (values[i + 1] - values[i]) * pct + values[i]
    return values[-1]


class PlainTrainer:
    """The reference's training state: parameters (leaves that train) and
    buffers, and torch's AdamW over the parameters."""

    def __init__(self, model: PlainRAFT, params: Dict[str, torch.Tensor], trainable: List[str],
                 lr: float, wdecay: float, eps: float, clip: float, num_steps: int):
        self.model = model
        self.p = {k: (v.detach().clone().requires_grad_(k in trainable)) for k, v in params.items()}
        self.trainable = list(trainable)
        self.lr, self.num_steps, self.clip = lr, num_steps, clip
        self.opt = torch.optim.AdamW([self.p[k] for k in self.trainable], lr=lr,
                                     betas=(0.9, 0.999), eps=eps, weight_decay=wdecay)
        self.count = 0

    def step(self, batch: Dict[str, torch.Tensor], iters: int, gamma: float, rows: int):
        """One step on the global batch, `rows` rows at a time. Returns
        (loss, global gradient norm before the clip, {leaf: clipped gradient})."""
        n = batch["image1"].shape[0]
        for k in self.trainable:
            self.p[k].grad = None
        total = torch.zeros((), dtype=torch.float32, device=batch["image1"].device)
        for lo in range(0, n, rows):
            sl = slice(lo, min(lo + rows, n))
            preds = self.model.forward(self.p, batch["image1"][sl], batch["image2"][sl], iters,
                                       test_mode=False)
            part = sequence_loss(preds, batch["flow"][sl], batch["valid"][sl], gamma)
            part = part * ((sl.stop - sl.start) / n)
            part.backward()
            total = total + part.detach()
            del preds, part
        grads = [self.p[k].grad if self.p[k].grad is not None else torch.zeros_like(self.p[k])
                 for k in self.trainable]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        with torch.no_grad():
            for k, g in zip(self.trainable, grads):
                self.p[k].grad = g * scale
        self.opt.param_groups[0]["lr"] = onecycle_lr(self.count, self.lr, self.num_steps)
        self.opt.step()
        self.count += 1
        clipped = {k: self.p[k].grad.detach().clone() for k in self.trainable}
        return total, norm.detach(), clipped
