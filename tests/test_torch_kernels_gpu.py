"""CUDA kernels of the port against their plain versions, on the card.

Needs a CUDA card: every test is marked `gpu` and skips without one (decided
inside the fixture, so every worker collects the same tests). The file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

K1 and K2 repeat their plain version's fp32 operations in the same order
without fused multiply-adds, so the two agree exactly. K3 (the volume
gradient) sums its at most four taps in another order than its plain
version's einsums: max_rel = max|d| / max|ref| within 2e-5 (fp32 volume) and
3e-2 (bf16), the repo's lookup-VJP gates.
"""

import os

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(device, h, w, dtype, seed, B=2, C=64):
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(device)
    f2 = torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(device)
    gy, gx = np.mgrid[0:h, 0:w]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-6, 6, coords.shape).astype(np.float32)
    coords[:, 0] += 1.0e7  # a row of queries far out of bounds
    return build_corr_pyramid_from_fmaps(f1, f2, 4, dtype), torch.from_numpy(coords).to(device)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
def test_kernels_match_plain(cuda, radius, vol_dtype, out_dtype):
    pyr, coords = _case(cuda, 15, 22, vol_dtype, seed=radius)
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).contiguous()
    for lvl, c in enumerate(pyr):
        cl = (flat / 2**lvl).contiguous()
        got = ck.corr_lookup_level(c, cl, radius, out_dtype)
        torch.testing.assert_close(got, ck.corr_lookup_level_plain(c, cl, radius, out_dtype),
                                   rtol=0, atol=0)
    got = ck.corr_lookup_coarse_fused(pyr[1:], flat, radius, out_dtype)
    torch.testing.assert_close(
        got, ck.corr_lookup_coarse_fused_plain(pyr[1:], flat, radius, out_dtype), rtol=0, atol=0)


@pytest.mark.parametrize("fuse", [False, True])
def test_pyramid_lookup_with_empty_level(cuda, fuse):
    pyr, coords = _case(cuda, 7, 16, torch.float32, seed=5)
    assert pyr[-1].shape[2] == 0
    from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup

    ck.reset_launches()
    got = ck.corr_pyramid_lookup_cuda(pyr, coords, 3, torch.float32, fuse)
    torch.testing.assert_close(got, corr_pyramid_lookup(pyr, coords, 3), rtol=0, atol=0)
    expect = ({"corr_lookup_level": 1, "corr_lookup_coarse_fused": 1} if fuse
              else {"corr_lookup_level": 3, "corr_lookup_coarse_fused": 0})
    expect["corr_lookup_level_bwd"] = 0
    assert ck.LAUNCHES == expect


def test_raft_small_golden_on_card(cuda):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    model = RAFT(RAFTConfig(small=True))
    model.load_state_dict(load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz")))
    i1 = torch.from_numpy(g["image1"].astype(np.float32))[None].to(cuda)
    i2 = torch.from_numpy(g["image2"].astype(np.float32))[None].to(cuda)
    _, flow_up = model(i1, i2, iters=int(g["iters"]))
    epe = np.linalg.norm(flow_up.cpu().numpy() - g["flow_up"], axis=-1)
    assert epe.mean() < 1e-3 and epe.max() < 5e-3


def _max_rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_bwd_matches_plain(cuda, radius, vol_dtype, g_dtype):
    pyr, coords = _case(cuda, 15, 22, vol_dtype, seed=10 + radius)
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(radius)
    K2 = (2 * radius + 1) ** 2
    g = torch.randn(B, h * w, K2, device=cuda, generator=gen).to(g_dtype)
    ck.reset_launches()
    for lvl, c in enumerate(pyr):
        cl = (flat / 2**lvl).contiguous()
        Hl, Wl = c.shape[2:]
        got = ck.corr_lookup_level_bwd(cl, g, Hl, Wl, radius, vol_dtype)
        ref = ck.corr_lookup_level_bwd_plain(cl, g, Hl, Wl, radius, torch.float32)
        assert got.dtype == vol_dtype and got.shape == (B, h * w, Hl, Wl)
        tol = 2e-5 if vol_dtype == torch.float32 else 3e-2
        assert _max_rel(got, ref) <= tol, (lvl, _max_rel(got, ref))
        assert torch.all(got[:, :w] == 0)  # the far out-of-bounds row
    assert ck.LAUNCHES["corr_lookup_level_bwd"] == len(pyr)


def test_lookup_function_backward_on_card(cuda):
    pyr, coords = _case(cuda, 9, 12, torch.bfloat16, seed=3)
    tp = [c.detach().requires_grad_() for c in pyr]
    ck.reset_launches()
    out = ck.corr_pyramid_lookup_cuda(tp, coords, 4, torch.bfloat16)
    out.float().square().sum().backward()
    assert ck.LAUNCHES == {"corr_lookup_level": 4, "corr_lookup_coarse_fused": 0,
                           "corr_lookup_level_bwd": 4}
    assert all(p.grad.dtype == torch.bfloat16 and torch.isfinite(p.grad.float()).all() for p in tp)


def test_lookup_bwd_empty_level_launches_nothing(cuda):
    coords = torch.zeros(1, 5, 2, device=cuda)
    g = torch.ones(1, 5, 49, device=cuda)
    ck.reset_launches()
    assert ck.corr_lookup_level_bwd(coords, g, 0, 3, 3).shape == (1, 5, 0, 3)
    assert ck.LAUNCHES["corr_lookup_level_bwd"] == 0
