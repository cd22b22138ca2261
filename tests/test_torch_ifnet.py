"""The port's IFNet against the reference golden and the JAX package.

Tolerances:
  - fp32 at the golden's params against the reference torch outputs: the
    bar of tests/test_simple_ifnet_parity.py (flows atol 2e-3, masks and
    warped images 1e-3); the bf16 policy against the same golden at
    test_ifnet_bf16_policy_close's bar (flow_2 mean |d| < 5e-3, max <
    5e-2); feature_res_warp against the reference order at
    test_ifnet_feature_res_warp_close's bar (flow_0 equal, later flows mean
    |d| < 0.06, max < 0.5);
  - against the jitted JAX model at the golden's params, batch 2: fp32 at
    64x96 and 50x70, and with feature_res_warp at 64x96, every flow, mask
    and warped image within 1e-4; bf16 at 50x70 at the policy bar above;
  - each IFBlock case against JAX's (`check_module` of
    tests/test_torch_simple_flow.py: fp32 within 1e-5 * max|ref| layer by
    layer, bf16 against JAX op by op with every layer's dtype JAX's and
    its mean|d| / mean|ref| within IFBLOCK_BF16: layers 2e-3, 4x the worst
    reading, 4.85e-4 (a conv's sums in another order), and outputs 5e-3,
    3x the worst, 1.59e-3, where the head's bf16 output is resized: JAX's
    resize casts its weights to bf16 and contracts each axis in bf16,
    `F.interpolate` keeps fp32 weights and rounds once).
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models import ifnet as jif
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.models import IFNet, ifnet
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from test_torch_simple_flow import POLICIES, _nchw, _port, _sub, check_module
from torch_threads import one_torch_thread  # noqa: F401

# the module, not the constructor of the same name that `models` exports
tif = importlib.import_module("raft_optical_flow_tpu_torch.models.ifnet")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FP32, BF16 = torch.float32, torch.bfloat16
IFBLOCK_BF16 = (2e-3, 5e-3)  # layers, outputs


@pytest.fixture(scope="module")
def golden():
    path = os.path.join(GOLDENS, "ifnet_params.npz")
    return jax.tree.map(jnp.asarray, jax_load(path)), load_flax_npz(path)


@functools.partial(jax.jit, static_argnums=(3, 4))
def jax_ifnet(variables, img0, img1, bf16, frw):
    return jif.IFNet(compute_dtype=jnp.bfloat16 if bf16 else jnp.float32,
                     feature_res_warp=frw).apply(variables, img0, img1)


# (name, input channels, scale, with a flow, input already at 1/scale)
BLOCK_CASES = [("block0", 7, 4, False, False), ("block1", 14, 2, True, False),
               ("block2", 14, 1, True, False), ("block1", 14, 2, True, True)]


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name,cin,scale,with_flow,small", BLOCK_CASES)
def test_ifblock(golden, name, cin, scale, with_flow, small, policy):
    jv, sd = golden
    rng = np.random.RandomState(cin + scale)
    H, W = 32, 48
    h, w = (H // scale, W // scale) if small else (H, W)
    x = rng.rand(2, h, w, cin).astype(np.float32)
    flow = rng.uniform(-2, 2, (2, h, w, 4)).astype(np.float32) if with_flow else None
    c = tif.BLOCK_WIDTHS[int(name[-1])]
    port = _port(tif.IFBlock(cin + 4 * (name != "block0"), c, POLICIES[policy][0]), sd, name)
    out_hw = (H, W) if small else None
    check_module(policy, jif.IFBlock(c), _sub(jv, name),
                 (jnp.asarray(x), None if flow is None else jnp.asarray(flow)),
                 port, (_nchw(x), None if flow is None else _nchw(flow)), ["flow", "mask"],
                 jkw=dict(scale=scale, out_hw=out_hw), pkw=dict(scale=scale, out_hw=out_hw),
                 bounds=IFBLOCK_BF16)


def _model(sd, dtype=FP32, frw=False):
    model = IFNet(compute_dtype=dtype, feature_res_warp=frw, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def _golden_images():
    g = np.load(os.path.join(GOLDENS, "ifnet.npz"))
    return g, [torch.from_numpy(g[k]).permute(0, 2, 3, 1).contiguous() for k in ("img0", "img1")]


def _c(x):
    return x.numpy().transpose(0, 3, 1, 2)


def test_matches_golden(golden):
    g, images = _golden_images()
    flows, masks, warped = _model(golden[1])(*images)
    assert len(flows) == len(masks) == len(warped) == 3
    for i in range(3):
        assert flows[i].dtype == masks[i].dtype == warped[i][0].dtype == FP32
        np.testing.assert_allclose(_c(flows[i]), g[f"flow_{i}"], atol=2e-3, err_msg=f"flow_{i}")
        np.testing.assert_allclose(_c(masks[i]), g[f"mask_{i}"], atol=1e-3, err_msg=f"mask_{i}")
        for j in range(2):
            np.testing.assert_allclose(_c(warped[i][j]), g[f"warped{j}_{i}"], atol=1e-3,
                                       err_msg=f"warped{j}_{i}")


def test_bf16_policy_close_to_golden(golden):
    g, images = _golden_images()
    flows, masks, _ = _model(golden[1], BF16)(*images)
    assert flows[-1].dtype == masks[-1].dtype == FP32
    diff = np.abs(_c(flows[-1]) - g["flow_2"])
    assert diff.mean() < 5e-3 and diff.max() < 5e-2, (diff.mean(), diff.max())


def test_feature_res_warp_close_to_reference_order(golden):
    _, images = _golden_images()
    base, _, _ = _model(golden[1])(*images)
    frw, _, _ = _model(golden[1], frw=True)(*images)
    np.testing.assert_array_equal(frw[0].numpy(), base[0].numpy())
    for i in (1, 2):
        diff = (frw[i] - base[i]).abs()
        assert float(diff.mean()) < 0.06 and float(diff.max()) < 0.5, (i, diff.mean(), diff.max())
        assert float(diff.max()) > 0  # the warps did move


@pytest.mark.parametrize("hw,policy,frw", [((64, 96), "fp32", False), ((50, 70), "fp32", False),
                                           ((64, 96), "fp32", True), ((50, 70), "bf16", False)])
def test_matches_jax(golden, hw, policy, frw):
    jv, sd = golden
    rng = np.random.RandomState(hw[0])
    a, b = (rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32) for _ in range(2))
    ref = jax_ifnet(jv, jnp.asarray(a), jnp.asarray(b), policy == "bf16", frw)
    out = _model(sd, POLICIES[policy][0], frw)(torch.from_numpy(a), torch.from_numpy(b))
    if policy == "bf16":
        d = np.abs(out[0][-1].numpy() - np.asarray(ref[0][-1]))
        assert d.mean() < 5e-3 and d.max() < 5e-2, (d.mean(), d.max())
        return
    pairs = [(f, r) for f, r in zip(out[0], ref[0])] + [(m, r) for m, r in zip(out[1], ref[1])]
    pairs += [(w, r) for ws, rs in zip(out[2], ref[2]) for w, r in zip(ws, rs)]
    assert len(pairs) == 12
    for got, r in pairs:
        assert tuple(got.shape) == r.shape and got.dtype == FP32
        assert np.abs(got.numpy() - np.asarray(r)).max() <= 1e-4
    # the flows are not trivially small: the bound is meaningful
    assert float(np.abs(np.asarray(ref[0][-1])).mean()) > 0.1


def test_constructor_and_defaults():
    model = ifnet(device="cpu", compute_dtype=BF16, feature_res_warp=True)
    assert model.compute_dtype == BF16 and model.feature_res_warp and not model.training
    assert [getattr(model, f"block{i}").convblock_7_1.weight.shape[0] for i in range(3)] == [240, 150, 90]
    with pytest.raises(ValueError):
        IFNet(compute_dtype=torch.float16, device="cpu")
    a = ifnet(device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    b = ifnet(device="cpu", generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert (a["block0.conv0_0_1.weight"] == 0.25).all()
