"""IFNet's training gradients in the port against `jax.value_and_grad`, at
the golden's params, fp32, batch 2, 64x96: the losses of
`ifnet_train_step`, supervised (flow[..., 2:4] of every block through
`simple_flow_loss`) and unsupervised (`laploss` over the warped images),
through `check_gradients` of tests/test_torch_families_grad.py (JAX in
float64; the loss within rel 1e-5, each layer within max(2e-5, 2x the
floor)).
"""

import os

import pytest
import torch

from raft_optical_flow_tpu.losses.laploss import laploss as jax_laploss
from raft_optical_flow_tpu.losses.simple_flow_loss import simple_flow_loss as jax_sf_loss
from raft_optical_flow_tpu.models.ifnet import IFNet as JaxIFNet
from raft_optical_flow_tpu_torch.losses import laploss, simple_flow_loss
from raft_optical_flow_tpu_torch.models import IFNet
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz, state_dict_to_flax
from test_torch_families_grad import batch, check_gradients
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("unsupervised", [False, True])
def test_ifnet_gradients_match_jax(unsupervised):
    img1, img2, gt, valid = batch(1)
    sd = load_flax_npz(os.path.join(GOLDENS, "ifnet_params.npz"))

    def jax_loss(params, x):
        flows, _, warped = JaxIFNet().apply({"params": params}, x["img1"], x["img2"])
        if unsupervised:
            return jax_laploss(warped, x["img1"], x["img2"])[0]
        return jax_sf_loss([f[..., 2:4] for f in flows], x["gt"], x["valid"], x["img1"])[0]

    def port_loss(m):
        t1, t2 = torch.from_numpy(img1), torch.from_numpy(img2)
        flows, _, warped = m(t1, t2, train=True)
        if unsupervised:
            return laploss(warped, t1, t2)[0]
        preds = [f[..., 2:4] for f in flows]
        return simple_flow_loss(preds, torch.from_numpy(gt), torch.from_numpy(valid), t1)[0]

    port = IFNet(device="cpu")
    port.load_state_dict(sd, strict=True)
    inputs = dict(img1=img1, img2=img2, gt=gt, valid=valid)
    check_gradients(jax_loss, state_dict_to_flax(sd)["params"], inputs, port_loss, port)
