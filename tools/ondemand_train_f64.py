#!/usr/bin/env python3
"""How far the fp32 steps of phase `ondemand`'s gradient gate are from the truth.

    python3 tools/ondemand_train_f64.py

Runs the RAFT-small train step that `chip_smoke.py` phase `ondemand` gates
(the golden pair at 192x320, `checkpoints/raft_small.npz`, the golden's
training iterations; PyTorch's deterministic algorithms on) three ways on the
card: fp32 through K4-K6 (`alternate_corr`), fp32 through their plain
versions, and float64 through the plain all-pairs lookup (frames, weights and
every sum in float64: the same windows, computed to within float64's
rounding). Prints each layer's max|d| / max|ref| (`utils/grad_check.py`) of
both fp32 steps against float64 and of the kernel step against the plain
one, the gate's comparison: a layer whose two fp32 steps each sit far from
float64 (a ReLU that flips under rounding) is ill-conditioned, and its
kernel-against-plain reading says nothing of the kernels. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from raft_optical_flow_tpu_torch.models import RAFTConfig  # noqa: E402
from raft_optical_flow_tpu_torch.train import StageConfig  # noqa: E402
from raft_optical_flow_tpu_torch.train.trainer import create_train_state, raft_train_step  # noqa: E402
from raft_optical_flow_tpu_torch.utils.grad_check import layer_max_rel  # noqa: E402
from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ondemand_train_f64: needs a CUDA card", file=sys.stderr)
        return 1
    gold = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    ckpt = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    stage = StageConfig(name="smoke-small", stage="chairs", num_steps=100, batch_size=1,
                        lr=1e-4, image_size=(192, 320), small=True)
    iters = int(gold["train_iters"])

    def step(cfg, dtype):
        st = create_train_state(cfg, stage, ckpt, "cuda")
        st.model.to(dtype)
        batch = {"image1": torch.from_numpy(gold["image1"])[None],
                 "image2": torch.from_numpy(gold["image2"])[None],
                 "flow": torch.from_numpy(gold["flow_up"]),
                 "valid": torch.ones(1, 192, 320)}
        metrics = raft_train_step(st, {k: v.to("cuda", dtype) for k, v in batch.items()},
                                  iters=iters)
        return float(metrics["loss"]), {k: p.grad.double() for k, p in
                                        st.model.named_parameters()}

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {
        "float64": step(RAFTConfig(small=True, compute_dtype=torch.float64, corr_impl="plain"),
                        torch.float64),
        "fp32 plain": step(RAFTConfig(small=True, alternate_corr=True, corr_impl="plain"),
                           torch.float32),
        "fp32 kernels": step(RAFTConfig(small=True, alternate_corr=True), torch.float32),
    }
    print(f"{torch.cuda.get_device_name(0)}; losses "
          + ", ".join(f"{k} {v[0]!r}" for k, v in runs.items()))
    rel = {
        "plain vs float64": layer_max_rel(runs["fp32 plain"][1], runs["float64"][1]),
        "kernels vs float64": layer_max_rel(runs["fp32 kernels"][1], runs["float64"][1]),
        "kernels vs plain (the gate, 2e-5)": layer_max_rel(runs["fp32 kernels"][1],
                                                           runs["fp32 plain"][1]),
    }
    names = list(rel["kernels vs plain (the gate, 2e-5)"])
    print("layer " + " | ".join(rel))
    for n in names:
        print(f"{n} " + " | ".join(f"{r[n]:.3e}" for r in rel.values()))
    for what, r in rel.items():
        worst = max(r, key=r.get)
        print(f"worst {what}: {worst} {r[worst]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
