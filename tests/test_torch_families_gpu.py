"""The port's SimpleFlowNet and IFNet on the card: against the reference
goldens and against the port on the CPU.

Needs a CUDA card: every test is marked `gpu` and skips without one (decided
inside the fixture). The file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_families_gpu.py

Tolerances: fp32 (TF32 off) at the goldens' params at the bars of
tests/test_simple_ifnet_parity.py (SimpleFlowNet's flows atol 1e-3;
IFNet's flows 2e-3, masks and warped images 1e-3); the bf16 policies at
its bf16 bars (SimpleFlowNet per scale mean |d| < 4e-2, max < 2e-1; IFNet
flow_2 mean < 5e-3, max < 5e-2); feature_res_warp against the reference
order (flow_0 equal, later flows mean < 0.06, max < 0.5); the card's fp32
flows within 1e-4 of the port's on the CPU at the same weights (64x96,
batch 2), the bar the port holds against JAX.
"""

import os

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.models import IFNet, SimpleFlowConfig, SimpleFlowNet
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

pytestmark = pytest.mark.gpu
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def simple_flow(device, dtype=torch.float32):
    model = SimpleFlowNet(SimpleFlowConfig(compute_dtype=dtype), device=device)
    model.load_state_dict(load_flax_npz(os.path.join(GOLDENS, "simple_flow_params.npz")))
    return model


def ifnet(device, dtype=torch.float32, frw=False):
    model = IFNet(compute_dtype=dtype, feature_res_warp=frw, device=device)
    model.load_state_dict(load_flax_npz(os.path.join(GOLDENS, "ifnet_params.npz")))
    return model


def _golden(name, keys, device):
    g = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    return g, [torch.from_numpy(g[k]).permute(0, 2, 3, 1).contiguous().to(device) for k in keys]


def _c(x):
    return x.permute(0, 3, 1, 2).cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_simple_flow_matches_golden_on_card(cuda, dtype):
    g, images = _golden("simple_flow", ("img1", "img2"), cuda)
    flows = simple_flow(cuda, dtype)(*images)
    for i, f in enumerate(flows):
        assert f.dtype == torch.float32
        diff = np.abs(_c(f) - g[f"flow_{i}"])
        if dtype == torch.float32:
            assert diff.max() <= 1e-3, (i, diff.max())
        else:
            assert diff.mean() < 4e-2 and diff.max() < 2e-1, (i, diff.mean(), diff.max())


def test_ifnet_matches_golden_on_card(cuda):
    g, images = _golden("ifnet", ("img0", "img1"), cuda)
    flows, masks, warped = ifnet(cuda)(*images)
    for i in range(3):
        np.testing.assert_allclose(_c(flows[i]), g[f"flow_{i}"], atol=2e-3, err_msg=f"flow_{i}")
        np.testing.assert_allclose(_c(masks[i]), g[f"mask_{i}"], atol=1e-3, err_msg=f"mask_{i}")
        for j in range(2):
            np.testing.assert_allclose(_c(warped[i][j]), g[f"warped{j}_{i}"], atol=1e-3,
                                       err_msg=f"warped{j}_{i}")


def test_ifnet_bf16_and_feature_res_warp_on_card(cuda):
    g, images = _golden("ifnet", ("img0", "img1"), cuda)
    flows, masks, _ = ifnet(cuda, torch.bfloat16)(*images)
    assert flows[-1].dtype == masks[-1].dtype == torch.float32
    diff = np.abs(_c(flows[-1]) - g["flow_2"])
    assert diff.mean() < 5e-3 and diff.max() < 5e-2, (diff.mean(), diff.max())
    base, _, _ = ifnet(cuda)(*images)
    frw, _, _ = ifnet(cuda, frw=True)(*images)
    assert torch.equal(frw[0], base[0])
    for i in (1, 2):
        d = (frw[i] - base[i]).abs()
        assert float(d.mean()) < 0.06 and float(d.max()) < 0.5, (i, float(d.mean()), float(d.max()))


@pytest.mark.parametrize("model", ["simple_flow", "ifnet", "ifnet_frw"])
def test_card_matches_cpu(cuda, model):
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)) for _ in range(2))
    if model == "simple_flow":
        ref, out = simple_flow("cpu")(a, b), simple_flow(cuda)(a.to(cuda), b.to(cuda))
    else:
        frw = model == "ifnet_frw"
        ref = ifnet("cpu", frw=frw)(a, b)[0]
        out = ifnet(cuda, frw=frw)(a.to(cuda), b.to(cuda))[0]
    for f, r in zip(out, ref):
        assert float((f.cpu() - r).abs().max()) <= 1e-4
