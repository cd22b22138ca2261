"""The family trainers' pieces on the card: the deterministic splats and one
RAFT-small UFlow step against the port on the CPU.

Needs a CUDA card: every test is marked `gpu` and skips without one (decided
inside the fixture). The file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_flow_train_gpu.py

  - UFlow's range map and UnFlow's splat (`ops/unflow_ops.py::splat_sum`,
    fixed-point sums) give the same bits twice on the card and lie within
    1e-5 of the CPU's.
  - One `FlowTrainer('raft_uflow_unsup')` step at batch 2 on 48x64 crops of
    the golden frames (2 iterations, the masks and the self-supervision
    live): 6 launches each of K1 and its backward K3 per model run (the
    deepest level is empty at these sizes); the loss within rel 1e-5 of
    the CPU's and each layer's gradient, and its error against the port in
    float64 on the CPU, within `utils/grad_check.py::gradient_gate`:
    max(2e-5, 2x the spread of the card's step run twice, 2x the floor,
    the CPU step against itself with every weight changed by one ulp).
    RAFT-small's UFlow gradients are ill-conditioned: the floor reads
    about 7e-5, and fp32 rounding puts the CPU about 2e-5 and the card
    about 4e-5 from float64.
"""

import os

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.losses import uflow
from raft_optical_flow_tpu_torch.ops.unflow_ops import forward_warp_op
from raft_optical_flow_tpu_torch.models import RAFTConfig
from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer
from raft_optical_flow_tpu_torch.utils.grad_check import (
    flow_step,
    gradient_gate,
    layer_max_rel,
    nudge_weights,
    uflow_check_batch,
)
from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("splat", ["range_map", "range_map_4", "forward_warp_op"])
@pytest.mark.parametrize("shape", [(4, 256, 384), (2, 37, 53)])
def test_splats_are_deterministic_and_match_the_cpu(cuda, splat, shape):
    fn = {"range_map": lambda f: uflow.compute_range_map(f, 1, False, False),
          "range_map_4": lambda f: uflow.compute_range_map(f, 4, True, True),
          "forward_warp_op": forward_warp_op}[splat]
    g = torch.Generator(device=cuda).manual_seed(1)
    flow = torch.rand(*shape, 2, device=cuda, generator=g) * 16.0 - 8.0
    a, b = fn(flow), fn(flow)
    assert torch.equal(a, b)
    assert float((a.cpu() - fn(flow.cpu())).abs().max()) <= 1e-5


def test_uflow_step_matches_the_cpu(cuda):
    batch = uflow_check_batch(REPO)
    restore = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    kw = dict(iters=2, occlusion_warmup_steps=0)
    f64 = RAFTConfig(small=True, corr_impl="plain", compute_dtype=torch.float64)
    runs = []
    for device, config, nudge in ((cuda, None, False), (cuda, None, False), ("cpu", None, False),
                                  ("cpu", None, True), ("cpu", f64, False)):
        trainer = FlowTrainer("raft_uflow_unsup", (48, 64), model_config=config,
                              restore_variables=restore, device=device, step_kwargs=kw)
        if nudge:
            nudge_weights(trainer.model)
        ck.reset_launches()
        dtype = np.float64 if config is f64 else np.float32
        runs.append(flow_step(trainer, {k: v.astype(dtype) for k, v in batch.items()}, step=200))
        if device != "cpu":
            # 4 runs x 2 iterations x 3 levels: the deepest level of 48x64
            # (6x8 -> 0x1) and of its 32x48 crop (4x6 -> 0x0) is empty
            assert ck.LAUNCHES["corr_lookup_level"] == ck.LAUNCHES["corr_lookup_level_bwd"] == 24
    (m1, g1), (_, g2), (cpu_m, cpu_grads), (_, nudged), (_, g64) = runs
    assert abs(m1["loss"] - cpu_m["loss"]) <= 1e-5 * abs(cpu_m["loss"])
    gate = gradient_gate(layer_max_rel(g2, g1), layer_max_rel(nudged, cpu_grads))
    rels, card_err = layer_max_rel(g1, cpu_grads), layer_max_rel(g1, g64)
    bad = {n: (rels[n], card_err[n], gate[n]) for n in rels
           if not (rels[n] <= gate[n] and card_err[n] <= gate[n])}
    assert not bad, bad
