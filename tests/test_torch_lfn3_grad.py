"""LiteFlowNet3's train steps in the port against the JAX package's.

`multiscale_sequence_loss` against the JAX package's, value and gradient
(the GT mask's nearest resize picks JAX's rows, 436 -> 109 among the
shapes). Then one step of `lfn3_train_step` and one of
`lfn3_unsup_train_step` (forward and backward passes, `unsupervised_loss`
on the five-level pyramid) for the standard variant here, and of
`lfn3_train_step` for S+PseudoReg (which has every S-only module) in
tests/test_torch_lfn3_grad_s.py (a file of its own, so that another worker
takes it), fp32, batch 2, 64x96, each at its golden's params,
through `check_step` of tests/test_torch_families_grad.py with JAX in fp32:
the loss and metrics (`grad_norm` included) within rel 1e-5; each layer's
gradient (weight and bias together) on its own scale, max|d| / max|ref|
within max(2e-5, 2x the case's floor): JAX against itself under a (1 +-
1e-7) change of every weight, measured in the same test (ROADMAP.md's rule
for gradient comparisons).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.losses.sequence import multiscale_sequence_loss as jax_loss
from raft_optical_flow_tpu.models.liteflownet3 import LFN3Config as JaxLFN3Config
from raft_optical_flow_tpu_torch.losses import multiscale_sequence_loss
from raft_optical_flow_tpu_torch.models import LFN3Config
from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint
from test_torch_families_grad import check_step, step_batch
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("H,W,levels", [(64, 96, ((64, 96), (16, 24), (8, 12), (4, 6), (2, 3))),
                                        (436, 64, ((109, 16), (55, 8))),
                                        (50, 70, ((50, 70), (13, 18), (7, 9), (4, 5), (2, 3), (1, 2)))])
def test_multiscale_loss_matches_jax(H, W, levels):
    rng = np.random.RandomState(H)
    gt = rng.uniform(-5, 5, (2, H, W, 2)).astype(np.float32)
    gt[0, :3, :3] = 500.0  # past max_flow: invalid
    valid = (rng.rand(2, H, W) > 0.3).astype(np.float32)
    preds = [rng.uniform(-5, 5, (2, h, w, 2)).astype(np.float32) for h, w in levels]
    ref, vjp = jax.vjp(jax.jit(lambda p: jax_loss(p, jnp.asarray(gt), jnp.asarray(valid))),
                       [jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    loss = multiscale_sequence_loss(tp, torch.from_numpy(gt), torch.from_numpy(valid))
    assert abs(loss.item() - float(ref)) <= 1e-6 * abs(float(ref))
    loss.backward()
    for t, g in zip(tp, vjp(jnp.ones((), jnp.float32))[0]):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-6 * np.abs(g).max()


def check_gradients(name, kw, kind="lfn3"):
    """One `FlowTrainer(kind)` step of the variant of config `kw` at the
    golden `name`'s params, in the port against the JAX package's step
    (`check_step` of tests/test_torch_families_grad.py, JAX in fp32): loss,
    metrics, `grad_norm` and each layer's gradient."""
    variables = load_flax_checkpoint(os.path.join(GOLDENS, f"lfn3_{name}_params.npz"))
    check_step(kind, variables, step_batch(), JaxLFN3Config(**kw), LFN3Config(**kw), x64=False)


def test_gradients_match_jax():
    check_gradients("standard", dict())


def test_unsup_gradients_match_jax():
    check_gradients("standard", dict(), kind="lfn3_unsup")
