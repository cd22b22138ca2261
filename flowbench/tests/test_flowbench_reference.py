"""The benchmark's plain reference against the program's plain path, on the
CPU at a tiny size, on the benchmark's seeded weights: RAFT-standard and
RAFT-small in test mode under both policies, and three training steps.

On the CPU the program runs every kernel's plain version, so the serving
outputs agree bit for bit (the reference repeats the plain lookup's fp32
operations and the same convs). In training the program's lookup gradient
(its plain K3, an einsum per level) sums in another order than the
reference's (the gather's scatter, in fp32): fp32 losses and gradient norms
within 1e-5 relative, bf16 within 1e-3 (a few bf16 steps of 2^-8)."""

import pytest
import torch

from flowbench.reference.raft import Arch, PlainRAFT, param_shapes
from flowbench.reference.train import PlainTrainer, onecycle_lr
from flowbench.weights import make_weights, trainable
from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.train.configs import StageConfig
from raft_optical_flow_tpu_torch.train.trainer import (
    create_train_state,
    linear_onecycle_schedule,
    raft_train_step,
)

POLICY = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("small", [False, True])
def test_parameter_names_match_the_program(small):
    sd = RAFT(RAFTConfig(small=small), device="cpu").state_dict()
    shapes = {n: s for n, s, _ in param_shapes(Arch(small))}
    assert set(sd) == set(shapes)
    assert all(tuple(sd[n].shape) == s for n, s in shapes.items())


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_serving_matches_the_program(small, policy):
    arch = Arch(small)
    w = make_weights(arch, 2**31 + 7, "cpu")
    model = RAFT(RAFTConfig(small=small, compute_dtype=POLICY[policy]), device="cpu")
    model.load_state_dict(w)
    g = torch.Generator().manual_seed(3)
    i1, i2 = (torch.rand(2, 48, 64, 3, generator=g) * 255 for _ in range(2))
    lo, up = model(i1, i2, iters=4, test_mode=True)
    r_lo, r_up = PlainRAFT(arch, policy).forward(w, i1, i2, 4, test_mode=True)
    assert torch.isfinite(up).all() and float(up.abs().mean()) > 0.1
    assert torch.equal(lo, r_lo) and torch.equal(up, r_up)


def test_schedule_matches_the_program():
    s = linear_onecycle_schedule(120_100, 1.25e-4, 0.05, 1.0, 25.0, 1e4)
    for c in (0, 1, 2, 6004, 6005, 6006, 100_000, 120_099, 120_100, 130_000):
        assert onecycle_lr(c, 1.25e-4, 120_000) == pytest.approx(s(c), rel=1e-12)


@pytest.mark.parametrize("policy,tol", [("fp32", 1e-5), ("bf16", 1e-3)])
def test_training_matches_the_program(policy, tol):
    arch = Arch(False)
    w = make_weights(arch, 5, "cpu")
    stage = StageConfig(name="t", stage="t", num_steps=1000, batch_size=2, lr=1e-4,
                        image_size=(48, 64), mixed_precision=policy == "bf16")
    st = create_train_state(RAFTConfig(compute_dtype=POLICY[policy]), stage, device="cpu")
    st.model.load_state_dict(w)
    ref = PlainTrainer(PlainRAFT(arch, policy), w, trainable(arch), stage.lr, stage.wdecay,
                       stage.epsilon, stage.clip, stage.num_steps)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        b = dict(image1=torch.rand(2, 48, 64, 3, generator=g) * 255,
                 image2=torch.rand(2, 48, 64, 3, generator=g) * 255,
                 flow=torch.randn(2, 48, 64, 2, generator=g) * 3, valid=torch.ones(2, 48, 64))
        m = raft_train_step(st, b, iters=3, gamma=0.8, freeze_bn=True)
        loss, norm, _ = ref.step(b, 3, 0.8, rows=1)  # two blocks of one row
        assert float(m["loss"]) == pytest.approx(float(loss), rel=tol)
        assert float(m["grad_norm"]) == pytest.approx(float(norm), rel=tol)
