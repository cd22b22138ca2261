"""SimpleFlowNet's supervised train step in the port against the JAX
package's (`check_step` of tests/test_torch_families_grad.py, JAX in
float64), at the golden's params, fp32, batch 2, 64x96: one step of
`simple_flow_train_step` (its BatchNorms in training mode;
`simple_flow_loss(preds, gt, valid, img1)`), its loss, metrics and
`grad_norm`, each layer's gradient, and the BatchNorm statistics it leaves.
The same for the unsupervised step, `simple_flow_unsup_train_step` (the
forward pass and then the backward pass, the running statistics chained
through both as flax's mutable `batch_stats` are; `unsupervised_loss`), at
32x48: the JAX step's compile in float64 is the cost of this file, and
smaller frames compile and run faster while both passes still chain.
"""

import os

from raft_optical_flow_tpu.models.simple_flow import SimpleFlowConfig as JaxSimpleFlowConfig
from raft_optical_flow_tpu_torch.models import SimpleFlowConfig
from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint
from test_torch_families_grad import check_step, step_batch
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def test_simple_flow_gradients_match_jax():
    variables = load_flax_checkpoint(os.path.join(GOLDENS, "simple_flow_params.npz"))
    check_step("simple_flow", variables, step_batch(), JaxSimpleFlowConfig(), SimpleFlowConfig())


def test_simple_flow_unsup_step_matches_jax():
    variables = load_flax_checkpoint(os.path.join(GOLDENS, "simple_flow_params.npz"))
    check_step("simple_flow_unsup", variables, step_batch(2, H=32, W=48), JaxSimpleFlowConfig(),
               SimpleFlowConfig())
