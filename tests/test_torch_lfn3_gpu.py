"""The port's LiteFlowNet3 on the card: against the reference goldens and
against the port on the CPU.

Needs a CUDA card: every test is marked `gpu` and skips without one (decided
inside the fixture). The file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_lfn3_gpu.py

Tolerances: standard and S+PseudoReg at the goldens' params, fp32 (TF32
off), at tests/test_lfn3_parity.py's bar ("flows" atol 3e-3, "confs" 1e-3,
every flow_pred_i and conf_pred_i 5e-4); the bf16 policy at
test_lfn3_bf16_policy_close's bar; all four variants' fp32 "flows" on the
card within 1e-4 of the port's on the CPU at the same weights (64x96, batch
2), the bar the port holds against JAX.
"""

import os

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

pytestmark = pytest.mark.gpu
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
VARIANTS = {
    "standard": dict(),
    "s": dict(use_s_version=True),
    "standard_pseudoreg": dict(use_pseudo_regularization=True),
    "s_pseudoreg": dict(use_s_version=True, use_pseudo_regularization=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def goldens():
    return {name: load_flax_npz(os.path.join(GOLDENS, f"lfn3_{name}_params.npz"))
            for name in ("standard", "s_pseudoreg")}


def golden_model(variant, goldens, device, dtype=torch.float32):
    """The variant at the goldens' params: each weight from the golden of the
    nearer variant that has its name and shape (the two goldens cover every
    name of the four variants). Also used by tests/test_torch_lfn3.py."""
    first = "s_pseudoreg" if VARIANTS[variant].get("use_s_version") else "standard"
    order = [goldens[first]] + [g for n, g in goldens.items() if n != first]
    model = LiteFlowNet3(LFN3Config(compute_dtype=dtype, **VARIANTS[variant]), device=device)
    sd = {k: next(g[k] for g in order if k in g and g[k].shape == v.shape)
          for k, v in model.state_dict().items()}
    model.load_state_dict(sd, strict=True)
    return model


def _golden_images(name, device):
    g = np.load(os.path.join(GOLDENS, f"lfn3_{name}.npz"))
    return g, torch.from_numpy(g["images"]).permute(0, 1, 3, 4, 2).contiguous().to(device)


@pytest.mark.parametrize("name", ["standard", "s_pseudoreg"])
def test_matches_golden_on_card(cuda, goldens, name):
    g, images = _golden_images(name, cuda)
    with torch.no_grad():
        out = golden_model(name, goldens, cuda)(images, training=True)
    np.testing.assert_allclose(out["flows"].permute(0, 1, 4, 2, 3).cpu().numpy(), g["flows"],
                               atol=3e-3)
    np.testing.assert_allclose(out["confs"].permute(0, 1, 4, 2, 3).cpu().numpy(), g["confs"],
                               atol=1e-3)
    for key in ("flow_pred", "conf_pred"):
        for i, p in enumerate(out[key + "s"]):
            np.testing.assert_allclose(p.permute(0, 3, 1, 2).cpu().numpy(), g[f"{key}_{i}"],
                                       atol=5e-4, err_msg=f"{key}_{i}")


def test_bf16_policy_close_to_golden_on_card(cuda, goldens):
    g, images = _golden_images("standard", cuda)
    out = golden_model("standard", goldens, cuda, torch.bfloat16)(images)
    assert out["flows"].dtype == out["confs"].dtype == torch.float32
    diff = np.abs(out["flows"].permute(0, 1, 4, 2, 3).cpu().numpy() - g["flows"])
    assert diff.mean() < 5e-3 and diff.max() < 5e-2, (diff.mean(), diff.max())
    assert np.abs(out["confs"].permute(0, 1, 4, 2, 3).cpu().numpy() - g["confs"]).mean() < 5e-3


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_card_matches_cpu(cuda, goldens, variant):
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 1, (2, 2, 64, 96, 3)).astype(np.float32))
    ref = golden_model(variant, goldens, "cpu")(images)
    out = golden_model(variant, goldens, cuda)(images.to(cuda))
    assert float((out["flows"].cpu() - ref["flows"]).abs().max()) <= 1e-4
    assert float((out["confs"].cpu() - ref["confs"]).abs().max()) <= 1e-5
