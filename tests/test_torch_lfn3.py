"""The port's LiteFlowNet3 against the reference goldens and the JAX package.

Tolerances:
  - standard and S+PseudoReg, fp32, at the goldens' params against the
    reference torch outputs: the bar of tests/test_lfn3_parity.py ("flows"
    atol 3e-3, "confs" 1e-3, every flow_pred_i and conf_pred_i 5e-4);
  - the bf16 policy against the same fp32 golden: that of
    test_lfn3_bf16_policy_close ("flows" fp32, mean |d| < 5e-3, max < 5e-2;
    "confs" mean < 5e-3), and each variant's bf16 "flows" against its own
    fp32 ones at the same bar;
  - S and standard+PseudoReg, which have no golden, and a 50x70 input (the
    InputScaler path) against the jitted JAX model at the goldens' params
    (every name of these variants is in one of the two goldens), batch 2:
    "flows" within 1e-4, every flow_pred_i within 1e-5, "confs" within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models.liteflownet3 import LFN3Config as JaxLFN3Config
from raft_optical_flow_tpu.models.liteflownet3 import LiteFlowNet3 as JaxLiteFlowNet3
from raft_optical_flow_tpu_torch.models import (
    LFN3Config,
    LiteFlowNet3,
    liteflownet3,
    liteflownet3_pseudoreg,
    liteflownet3s,
    liteflownet3s_pseudoreg,
)
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz, state_dict_to_flax
from test_torch_lfn3_gpu import VARIANTS, golden_model
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def golden_params():
    return {name: load_flax_npz(os.path.join(GOLDENS, f"lfn3_{name}_params.npz"))
            for name in ("standard", "s_pseudoreg")}


def _model(variant, golden_params, dtype=torch.float32):
    return golden_model(variant, golden_params, "cpu", dtype)


def _images(B, H, W, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, (B, 2, H, W, 3)).astype(np.float32)


def _nchw(x):
    return x.detach().numpy().transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", ["standard", "s_pseudoreg"])
def test_matches_golden(name, golden_params):
    g = np.load(os.path.join(GOLDENS, f"lfn3_{name}.npz"))
    images = torch.from_numpy(g["images"]).permute(0, 1, 3, 4, 2).contiguous()
    out = _model(name, golden_params)(images, training=True)
    flows = out["flows"].detach().numpy().transpose(0, 1, 4, 2, 3)
    confs = out["confs"].detach().numpy().transpose(0, 1, 4, 2, 3)
    assert out["flows"].dtype == out["confs"].dtype == torch.float32
    np.testing.assert_allclose(flows, g["flows"], atol=3e-3)
    np.testing.assert_allclose(confs, g["confs"], atol=1e-3)
    assert len(out["flow_preds"]) == 4
    assert len(out["conf_preds"]) == len([k for k in g.files if k.startswith("conf_pred_")])
    for i, f in enumerate(out["flow_preds"]):
        np.testing.assert_allclose(_nchw(f), g[f"flow_pred_{i}"], atol=5e-4, err_msg=f"flow_pred_{i}")
    for i, c in enumerate(out["conf_preds"]):
        np.testing.assert_allclose(_nchw(c), g[f"conf_pred_{i}"], atol=5e-4, err_msg=f"conf_pred_{i}")


def test_bf16_policy_close_to_golden(golden_params):
    g = np.load(os.path.join(GOLDENS, "lfn3_standard.npz"))
    images = torch.from_numpy(g["images"]).permute(0, 1, 3, 4, 2).contiguous()
    out = _model("standard", golden_params, torch.bfloat16)(images)
    assert out["flows"].dtype == out["confs"].dtype == torch.float32
    diff = np.abs(out["flows"].numpy().transpose(0, 1, 4, 2, 3) - g["flows"])
    assert diff.mean() < 5e-3, diff.mean()
    assert diff.max() < 5e-2, diff.max()
    assert np.abs(out["confs"].numpy().transpose(0, 1, 4, 2, 3) - g["confs"]).mean() < 5e-3


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_policy_close_to_fp32(variant, golden_params):
    images = torch.from_numpy(_images(2, 64, 96, seed=1))
    ref = _model(variant, golden_params)(images)
    out = _model(variant, golden_params, torch.bfloat16)(images)
    assert out["flows"].dtype == torch.float32 and out["flows"].shape == (2, 1, 64, 96, 2)
    diff = (out["flows"] - ref["flows"]).abs()
    assert float(diff.mean()) < 5e-3 and float(diff.max()) < 5e-2, (float(diff.mean()), float(diff.max()))
    assert float((out["confs"] - ref["confs"]).abs().mean()) < 5e-3


def test_constructors_and_defaults():
    for fn, kw in ((liteflownet3, VARIANTS["standard"]), (liteflownet3s, VARIANTS["s"]),
                   (liteflownet3_pseudoreg, VARIANTS["standard_pseudoreg"]),
                   (liteflownet3s_pseudoreg, VARIANTS["s_pseudoreg"])):
        model = fn(device="cpu", compute_dtype=torch.bfloat16)
        assert model.config == LFN3Config(compute_dtype=torch.bfloat16, **kw)
        assert hasattr(model, "pseudo_subpixel") == kw.get("use_pseudo_regularization", False)
        assert hasattr(model, "deformation_nets_2") == kw.get("use_s_version", False)
    with pytest.raises(ValueError):
        LiteFlowNet3(LFN3Config(compute_dtype=torch.float16), device="cpu")


@pytest.mark.parametrize("variant,hw", [("s", (64, 96)), ("standard_pseudoreg", (64, 96)),
                                        ("standard", (50, 70))])
def test_matches_jax(variant, hw, golden_params):
    images = _images(2, *hw, seed=2)
    model = _model(variant, golden_params)
    jax_model = JaxLiteFlowNet3(JaxLFN3Config(**VARIANTS[variant]))
    params = jax.tree.map(jnp.asarray, state_dict_to_flax(model.state_dict()))
    ref = jax.jit(lambda v, x: jax_model.apply(v, x, training=True))(params, jnp.asarray(images))
    out = model(torch.from_numpy(images), training=True)
    assert out["flows"].shape == (2, 1, *hw, 2) and out["confs"].shape == (2, 1, *hw, 1)
    assert np.abs(out["flows"].detach().numpy() - np.asarray(ref["flows"])).max() <= 1e-4
    assert np.abs(out["confs"].detach().numpy() - np.asarray(ref["confs"])).max() <= 1e-5
    for f, r in zip(out["flow_preds"], ref["flow_preds"]):
        assert np.abs(f.detach().numpy() - np.asarray(r)).max() <= 1e-5
    assert len(out["conf_preds"]) == len(ref["conf_preds"])
    # the flows are not trivially small: the bound is meaningful
    assert float(np.abs(np.asarray(ref["flows"])).mean()) > 0.01
