"""IFNet's train steps in the port against the JAX package's (`check_step`
of tests/test_torch_families_grad.py, JAX in float64), at the golden's
params, fp32, batch 2, 64x96: one step of `ifnet_train_step`, supervised
(flow[..., 2:4] of every block through `simple_flow_loss`) and
unsupervised (`laploss` over the warped images): the loss, metrics and
`grad_norm` within rel 1e-5, each layer within max(2e-5, 2x the floor).
"""

import os

import pytest

from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint
from test_torch_families_grad import check_step, step_batch
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("unsupervised", [False, True])
def test_ifnet_gradients_match_jax(unsupervised):
    variables = load_flax_checkpoint(os.path.join(GOLDENS, "ifnet_params.npz"))
    check_step("ifnet_unsup" if unsupervised else "ifnet", variables, step_batch(1))
