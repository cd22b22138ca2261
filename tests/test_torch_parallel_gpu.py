"""K4 on a slab of query rows, as `parallel/spatial.py` runs it, on the card.

Needs a CUDA card: every test is marked `gpu` and skips without one. The
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py

A slab of rows given K4 with the frame's grid width (`grid_w`) takes the
whole frame's bf16 tiles of 4 rows x 16 queries when it starts on a
multiple of 4 rows, and so the same route per tile and the same values
(torch.equal, fp32 and bf16). Read as rows of 16 consecutive queries (no
grid width) its tiles differ, and a bf16 value may round one bf16 step
apart (the per-query route sums its dots in another order): within one
bf16 step plus 2e-5 * max|ref|, the repo's K4 bf16 gate. K5 (the fmap1
gradient) takes the same grid width: on a slab given the frame's, each
query's gradient is the frame's (torch.equal). The spatial correlation's
gradients through K4-K6 on one process (no group) are the frame's
autograd through `ondemand_corr_pyramid_cuda`, bit for bit.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

H, W, C, R = 56, 128, 256, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(device, dtype, seed=0):
    from raft_optical_flow_tpu_torch.ops.corr import avg_pool2x2

    g = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn(1, H, W, C, device=device, generator=g)
    pyr = [torch.randn(1, H, W, C, device=device, generator=g)]
    for _ in range(3):
        pyr.append(avg_pool2x2(pyr[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    gy, gx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    d = (torch.rand(1, H, W, 2, device=device, generator=g) * 2 - 1) * 6.0
    coords = torch.stack([gx, gy], -1)[None] + d
    return f1.to(dtype), [p.to(dtype).contiguous() for p in pyr], coords.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_slab_on_the_frame_grid_is_the_frame(cuda, dtype):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    f1, levels, coords = _inputs(cuda, dtype)
    flat1, flatc = f1.reshape(1, H * W, C).contiguous(), coords.reshape(1, H * W, 2)
    whole = co.corr_ondemand_fwd(flat1, levels, flatc, R, dtype)
    q0 = 28 * W
    slab = co.corr_ondemand_fwd(flat1[:, q0:].contiguous(), levels, flatc[:, q0:].contiguous(),
                                R, dtype, grid_w=W)
    assert torch.equal(slab, whole[:, q0:])
    rows16 = co.corr_ondemand_fwd(flat1[:, q0:].contiguous(), levels,
                                  flatc[:, q0:].contiguous(), R, dtype)
    ref = whole[:, q0:].float()
    bound = 2.0 ** -7 * ref.abs() + 2e-5 * ref.abs().max()  # one bf16 step + the sums' order
    assert torch.all((rows16.float() - ref).abs() <= bound)


def test_spatial_slab_is_the_frame_rows(cuda):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.parallel.mesh import Mesh
    from raft_optical_flow_tpu_torch.parallel.spatial import spatial_sharded_ondemand_corr

    mesh = Mesh(np.arange(2), ("space",), cuda, {})  # process 0 of two, as it sees itself
    f1, levels, coords = _inputs(cuda, torch.bfloat16, seed=1)
    slab = spatial_sharded_ondemand_corr(f1, levels, coords, R, mesh, out_dtype=torch.bfloat16)
    whole = co.ondemand_corr_pyramid_cuda(f1, levels, coords, R, out_dtype=torch.bfloat16)
    assert slab.shape == (1, H // 2, W, 4 * (2 * R + 1) ** 2)
    assert torch.equal(slab, whole[:, :H // 2])
    with pytest.raises(ValueError, match="must divide"):
        spatial_sharded_ondemand_corr(f1[:, 1:], levels, coords[:, 1:], R, mesh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_slab_on_the_frame_grid_is_the_frame(cuda, dtype):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    _, levels, coords = _inputs(cuda, dtype, seed=2)
    flatc = coords.reshape(1, H * W, 2)
    g = torch.randn(1, H * W, 4 * (2 * R + 1) ** 2, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3)).to(dtype)
    whole = co.corr_ondemand_bwd_df1(levels, flatc, g, R)
    assert torch.equal(whole, co.corr_ondemand_bwd_df1(levels, flatc, g, R, grid_w=W))
    for q0 in (28 * W, 12 * W):
        slab = co.corr_ondemand_bwd_df1(levels, flatc[:, q0:].contiguous(),
                                        g[:, q0:].contiguous(), R, grid_w=W)
        assert torch.equal(slab, whole[:, q0:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_gradients_of_one_process_are_the_frames(cuda, dtype):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.parallel.mesh import Mesh
    from raft_optical_flow_tpu_torch.parallel.spatial import spatial_sharded_ondemand_corr

    f1, levels, coords = _inputs(cuda, dtype, seed=4)
    g = torch.randn(1, H, W, 4 * (2 * R + 1) ** 2, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5))
    grads = []
    for fn in (lambda a, ls: spatial_sharded_ondemand_corr(a, ls, coords, R, _one(cuda)),
               lambda a, ls: co.ondemand_corr_pyramid_cuda(a, ls, coords, R)):
        a = f1.clone().requires_grad_(True)
        ls = [f.clone().requires_grad_(True) for f in levels]
        (fn(a, ls) * g).sum().backward()
        grads.append([a.grad] + [f.grad for f in ls])
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    # process 0 of two, as it sees itself (no group): the frame's gradient in its rows
    a = f1.clone().requires_grad_(True)
    half = Mesh(np.arange(2), ("space",), cuda, {})
    (spatial_sharded_ondemand_corr(a, levels, coords, R, half) * g[:, :H // 2]).sum().backward()
    ref = co.corr_ondemand_bwd_df1(levels, coords.reshape(1, H * W, 2),
                                   g.reshape(1, H * W, -1).contiguous(), R).to(dtype)
    assert torch.equal(a.grad[:, :H // 2], ref.reshape(a.shape)[:, :H // 2])
    assert not a.grad[:, H // 2:].any()


def _one(device):
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names=("data", "space"), device=device)
