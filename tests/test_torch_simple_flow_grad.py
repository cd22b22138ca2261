"""SimpleFlowNet's training gradients in the port against
`jax.value_and_grad` (`check_gradients` of tests/test_torch_families_grad.py,
JAX in float64), at the golden's params, fp32, batch 2, 64x96, its
BatchNorms in training mode: the loss of `simple_flow_train_step`,
`simple_flow_loss(preds, gt, valid, img1)`. (The unsupervised step's loss
is held against JAX in tests/test_torch_families_grad.py, and its two
passes' BatchNorm statistics in tests/test_torch_simple_flow.py.)
"""

import os

import torch

from raft_optical_flow_tpu.losses.simple_flow_loss import simple_flow_loss as jax_sf_loss
from raft_optical_flow_tpu.models import simple_flow as jsf
from raft_optical_flow_tpu_torch.losses import simple_flow_loss
from raft_optical_flow_tpu_torch.models import SimpleFlowNet
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz, state_dict_to_flax
from test_torch_families_grad import batch, check_gradients
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def test_simple_flow_gradients_match_jax():
    img1, img2, gt, valid = batch()
    sd = load_flax_npz(os.path.join(GOLDENS, "simple_flow_params.npz"))
    variables = state_dict_to_flax(sd)
    model = jsf.SimpleFlowNet(jsf.SimpleFlowConfig())

    def jax_loss(params, x):
        v = {"params": params, "batch_stats": x["batch_stats"]}
        preds, _ = model.apply(v, x["img1"], x["img2"], train=True, mutable=["batch_stats"])
        return jax_sf_loss(preds, x["gt"], x["valid"], x["img1"])[0]

    def port_loss(m):
        t1 = torch.from_numpy(img1)
        preds = m(t1, torch.from_numpy(img2), train=True)
        return simple_flow_loss(preds, torch.from_numpy(gt), torch.from_numpy(valid), t1)[0]

    port = SimpleFlowNet(device="cpu")
    port.load_state_dict(sd, strict=True)
    inputs = dict(img1=img1, img2=img2, gt=gt, valid=valid, batch_stats=variables["batch_stats"])
    check_gradients(jax_loss, variables["params"], inputs, port_loss, port)
