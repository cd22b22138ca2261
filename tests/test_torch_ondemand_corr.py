"""The on-demand correlation's forward (K4's plain version) against the JAX
package, on the CPU.

The same numpy inputs go through the port's `corr_ondemand_fwd` (on CPU
tensors: the plain blockwise version) and through the JAX package's oracle
`_ondemand_xla` (gather sampling), its dispatcher
`ondemand_corr_pyramid(impl='xla')` (blockwise), and its Pallas kernels in
interpret mode. Tolerances: rtol/atol 1e-4, the JAX package's own
kernel-vs-oracle bar (tests/test_kernels.py); the same against the
materialized lookup. The bf16 policy (bf16 operands, fp32 sums, a bf16
output) against the JAX fp32 path: max|d| <= 3e-2 * max|ref|, the repo's
bf16 gate (utils/grad_parity.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels import corr_ondemand_pallas as kp
from raft_optical_flow_tpu.kernels.corr_ondemand import _ondemand_xla, ondemand_corr_pyramid
from raft_optical_flow_tpu.ops.corr import avg_pool2x2
from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
from raft_optical_flow_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps, corr_pyramid_lookup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, B=2, H=12, W=16, C=32, levels=4, far=False):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-4, 4, coords.shape).astype(np.float32)
    if far:  # a row far out of bounds both ways, one straddling the border
        coords[:, 0, : W // 2] += 1.0e6
        coords[:, 0, W // 2 :] -= 3.0e9
        coords[:, 1, :, 0] = W + 2.5
    pyr = [jnp.asarray(f2)]
    for _ in range(levels - 1):
        pyr.append(avg_pool2x2(pyr[-1].transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1))
    return f1, [np.array(p) for p in pyr], coords


def _port(f1, pyr, coords, radius, dtype=torch.float32):
    B, H, W, C = f1.shape
    out = co.corr_ondemand_fwd(
        torch.from_numpy(f1).reshape(B, H * W, C).to(dtype),
        [torch.from_numpy(p).to(dtype) for p in pyr],
        torch.from_numpy(coords).reshape(B, H * W, 2), radius, dtype)
    return out.reshape(B, H, W, -1).float().numpy()


def _jax(fn, f1, pyr, coords, radius, **kw):
    return np.asarray(fn(jnp.asarray(f1), tuple(jnp.asarray(p) for p in pyr),
                         jnp.asarray(coords), radius, **kw))


@pytest.mark.parametrize("radius", [3, 4])
def test_plain_forward_matches_jax(radius):
    f1, pyr, coords = _inputs(seed=radius)
    got = _port(f1, pyr, coords, radius)
    np.testing.assert_allclose(got, _jax(_ondemand_xla, f1, pyr, coords, radius),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax(ondemand_corr_pyramid, f1, pyr, coords, radius,
                                         impl="xla"), rtol=1e-4, atol=1e-4)


def test_plain_forward_matches_materialized_lookup():
    f1, pyr, coords = _inputs(seed=5)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(pyr[0])
    ref = corr_pyramid_lookup(build_corr_pyramid_from_fmaps(t1, t2, 4), torch.from_numpy(coords), 4)
    np.testing.assert_allclose(_port(f1, pyr, coords, 4), ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["far", "empty_level"])
def test_plain_forward_edge_cases(case):
    """Far out-of-bounds coords (1e6, -3e9, the border), and a 56x88 frame
    (7x11 fmaps) whose pyramid ends in an empty 0x1 level; batch 2."""
    if case == "far":
        f1, pyr, coords = _inputs(seed=6, far=True)
    else:
        f1, pyr, coords = _inputs(seed=7, H=7, W=11)
        assert [p.shape[1:3] for p in pyr] == [(7, 11), (3, 5), (1, 2), (0, 1)]
    got = _port(f1, pyr, coords, 4)
    np.testing.assert_allclose(got, _jax(_ondemand_xla, f1, pyr, coords, 4), rtol=1e-4, atol=1e-4)
    if case == "far":
        assert np.all(got[:, 0] == 0)  # windows far outside every level read 0
    else:
        assert np.all(got[..., 3 * 81:] == 0)


def test_plain_version_covers_the_streaming_kernels(monkeypatch):
    """Budgets this small put every level on the Pallas streaming kernels
    (one fmap2 row per step): the one plain version (and the one CUDA kernel
    it checks) computes what both TPU variants compute, forward and VJP."""
    monkeypatch.setattr(kp, "_RESIDENT_BUDGET", 1024)
    monkeypatch.setattr(kp, "_CHUNK_BUDGET", 1024)
    f1, pyr, coords = _inputs(seed=8, B=1, H=10, W=12, C=16, levels=3)
    assert kp._level_geometry(jnp.asarray(pyr[0]))[4] > 1
    ref = _jax(kp.ondemand_corr_pyramid_pallas, f1, pyr, coords, 3, interpret=True)
    np.testing.assert_allclose(_port(f1, pyr, coords, 3), ref, rtol=1e-4, atol=1e-4)

    import jax

    G = np.random.RandomState(9).randn(*ref.shape).astype(np.float32)
    jgrads = jax.grad(
        lambda a, b: jnp.sum(kp.ondemand_corr_pyramid_pallas(
            a, b, jnp.asarray(coords), 3, interpret=True) * G), argnums=(0, 1))(
        jnp.asarray(f1), tuple(jnp.asarray(p) for p in pyr))
    flat = torch.from_numpy(coords).reshape(1, 120, 2)
    g = torch.from_numpy(G).reshape(1, 120, -1)
    df1 = co.corr_ondemand_bwd_df1([torch.from_numpy(p) for p in pyr], flat, g, 3)
    df2 = co.corr_ondemand_bwd_df2(torch.from_numpy(f1).reshape(1, 120, 16), flat, g,
                                   [p.shape[1:3] for p in pyr], 3)
    np.testing.assert_allclose(df1.reshape(f1.shape).numpy(), np.asarray(jgrads[0]),
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(df2, jgrads[1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_bf16_policy_forward_matches_jax_fp32():
    f1, pyr, coords = _inputs(seed=10, C=64)
    got = _port(f1, pyr, coords, 4, torch.bfloat16)
    ref = _jax(_ondemand_xla, f1, pyr, coords, 4)
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


def test_cpu_wrappers_launch_nothing_and_check_arguments():
    f1, pyr, coords = _inputs(seed=11, B=1, H=4, W=6, C=8, levels=2)
    t1 = torch.from_numpy(f1).reshape(1, 24, 8)
    tl = [torch.from_numpy(p) for p in pyr]
    tc = torch.from_numpy(coords).reshape(1, 24, 2)
    co.reset_launches()
    out = co.corr_ondemand_fwd(t1, tl, tc, 3, torch.bfloat16)
    assert out.shape == (1, 24, 2 * 49) and out.dtype == torch.bfloat16
    assert set(co.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        co.corr_ondemand_fwd(t1, [tl[0].bfloat16()], tc, 3)  # levels in another dtype
    with pytest.raises(ValueError):
        co.corr_ondemand_fwd(t1, tl, tc.double(), 3)
    with pytest.raises(ValueError):
        co.corr_ondemand_bwd_df1(tl, tc, torch.zeros(1, 24, 49), 3)  # g misses a level
    with pytest.raises(TypeError):
        co.corr_ondemand_fwd(t1, tl, tc, 3, torch.float16)


def test_kernel_source_is_plain_cuda():
    src = open(os.path.join(REPO, "raft_optical_flow_tpu_torch", "kernels", "csrc",
                            "corr_ondemand.cu")).read()
    assert "torch/extension.h" not in src and "pybind11" not in src and "atomicAdd" not in src
    for fn in ("raft_corr_ondemand_fwd", "raft_corr_ondemand_bwd_df1",
               "raft_corr_ondemand_bwd_df2"):
        assert f'extern "C" int {fn}(' in src
