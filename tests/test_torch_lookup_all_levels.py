"""The all-levels lookup (K8, `corr_pyramid_lookup_cuda_fused`) against the
JAX package's `corr_pyramid_lookup_pallas_fused`, on the CPU.

On the CPU the JAX function hands off to `ops/corr.py::corr_pyramid_lookup`
(`kernels/corr_lookup.py:474-477`); its Pallas body does not trace (ROADMAP.md
Queue 3), so that hand-off is what both sides compute: K1 at every level,
levels in order, fp32 out. The port's wrapper runs its plain version for CPU
tensors. Both compute the same fp32 bilinear sums of the same volume values:
within 1e-5 abs (fp32 and bf16 volumes alike).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.corr_lookup import corr_pyramid_lookup_pallas_fused
from raft_optical_flow_tpu.ops import corr as jcorr
from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.ops import corr as tcorr
from torch_threads import one_torch_thread  # noqa: F401

# one compiled program per case instead of an eager dispatch per op
_jax_lookup = jax.jit(corr_pyramid_lookup_pallas_fused, static_argnums=2)


def _case(seed, H, W, B=2, C=32, max_disp=6.0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-max_disp, max_disp, coords.shape).astype(np.float32)
    coords[:, 0, :2] += 1.0e6  # queries far outside every level
    return f1, f2, coords


# (7, 16): levels 7x16, 3x8, 1x4 and an empty 0x2
@pytest.mark.parametrize("hw", [(12, 16), (7, 16)])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_levels_plain_matches_jax(hw, radius, dtype):
    f1, f2, coords = _case(seed=radius + hw[0], H=hw[0], W=hw[1])
    jp = jcorr.build_corr_pyramid_from_fmaps(jnp.asarray(f1), jnp.asarray(f2), 4)
    jp = [c.astype(getattr(jnp, dtype)) for c in jp]
    ref = np.asarray(_jax_lookup(jp, jnp.asarray(coords), radius), np.float32)
    # the same volume values on both sides (exact in either dtype)
    tp = [torch.from_numpy(np.asarray(c, np.float32)).to(getattr(torch, dtype)) for c in jp]
    if hw == (7, 16):
        assert tp[-1].shape[2] == 0
    ck.reset_launches()
    out = ck.corr_pyramid_lookup_cuda_fused(tp, torch.from_numpy(coords), radius)
    K2 = (2 * radius + 1) ** 2
    assert out.dtype == torch.float32 and out.shape == (2, *hw, 4 * K2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    plain = ck.corr_pyramid_lookup_fused_plain(tp, torch.from_numpy(coords), radius)
    assert torch.equal(out, plain)
    assert torch.all(out[:, 0, :2] == 0)  # the far queries
    if hw == (7, 16):
        assert torch.all(out[..., 3 * K2:] == 0)  # the empty level
    assert ck.LAUNCHES["corr_lookup_all_levels"] == 0  # a CPU tensor runs the plain version


def test_all_levels_checks_its_inputs():
    f1, f2, coords = _case(seed=1, H=12, W=16)
    tp = tcorr.build_corr_pyramid_from_fmaps(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    c = torch.from_numpy(coords)
    with pytest.raises(TypeError):
        ck.corr_pyramid_lookup_cuda_fused([tp[0], tp[1].bfloat16()], c, 3)
    with pytest.raises(TypeError):
        ck.corr_pyramid_lookup_cuda_fused([p.double() for p in tp], c, 3)
    with pytest.raises(ValueError):
        ck.corr_pyramid_lookup_cuda_fused(tp, c[:, :-1], 3)
    with pytest.raises(ValueError):
        ck.corr_pyramid_lookup_cuda_fused([], c, 3)
    with pytest.raises(ValueError):
        ck.corr_pyramid_lookup_cuda_fused(tp, c.reshape(2, -1, 2), 3)
