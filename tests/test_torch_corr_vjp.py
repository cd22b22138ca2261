"""K3, the lookup's volume gradient, on the CPU: its plain version and the
autograd Function `LookupLevel` against the JAX package.

The reference is `jax.grad` through `corr_pyramid_lookup_pallas(...,
interpret=True)`, whose custom VJP runs the Pallas backward kernel in
interpret mode (the pattern of tests/test_kernels.py), on the same pyramid and
coords. Tolerances, max_rel = max|d| / max|ref| per level: 2e-5 with fp32
volumes and 3e-2 with bf16 ones, the repo's own lookup-VJP gates
(`utils/grad_parity.py`). The bf16 case uses a linear loss whose cotangent is
bf16-exact, so both sides differentiate the same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.corr_lookup import corr_pyramid_lookup_pallas
from raft_optical_flow_tpu.ops.corr import all_pairs_correlation, build_corr_pyramid
from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup
from torch_threads import one_torch_thread  # noqa: F401

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _inputs(seed, B=1, H=10, W=12, C=16, levels=3, far=True):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-4, 4, coords.shape).astype(np.float32)
    if far:  # a row far out of bounds both ways, and one straddling the border
        coords[:, 0, : W // 2] += 1.0e6
        coords[:, 0, W // 2 :] -= 3.0e9
        coords[:, 1, :, 0] = W + 2.5
    pyr = build_corr_pyramid(all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2)), levels)
    return [np.array(p) for p in pyr], coords, rng


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if ref.size == 0:
        assert got.shape == ref.shape
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_grads(pyr, coords, radius, G, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def loss(p):
        out = corr_pyramid_lookup_pallas(p, jnp.asarray(coords), radius, interpret=True,
                                         out_dtype=jdt)
        return jnp.sum(out.astype(jnp.float32) * G)

    grads = jax.jit(jax.grad(loss))([jnp.asarray(p, jdt) for p in pyr])
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(pyr, coords, radius, G, dtype):
    tp = [torch.from_numpy(p).to(dtype).requires_grad_() for p in pyr]
    out = ck.corr_pyramid_lookup_cuda(tp, torch.from_numpy(coords), radius, dtype)
    (out.float() * torch.from_numpy(G)).sum().backward()
    assert all(p.grad.dtype == dtype for p in tp)
    return [p.grad.float().numpy() for p in tp]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_vjp_matches_jax_pallas(radius, dtype):
    pyr, coords, rng = _inputs(seed=radius)
    K2 = (2 * radius + 1) ** 2
    G = rng.randn(*coords.shape[:3], len(pyr) * K2).astype(np.float32)
    G = np.array(jnp.asarray(G, jnp.bfloat16).astype(jnp.float32))  # bf16-exact cotangent
    ref = _jax_grads(pyr, coords, radius, G, dtype)
    got = _port_grads(pyr, coords, radius, G, dtype)
    for lvl, (a, b) in enumerate(zip(got, ref)):
        assert _max_rel(a, b) <= TOL[dtype], (lvl, _max_rel(a, b))
    # the far out-of-bounds queries get no gradient at all
    assert all(np.all(a[:, : coords.shape[2]] == 0) for a in got)


def test_lookup_vjp_empty_level_matches_jax():
    """A 6x8 crop: the deepest of four levels is empty; its gradient is an
    empty tensor and the other levels still match."""
    pyr, coords, rng = _inputs(seed=8, H=6, W=8, levels=4, far=False)
    assert pyr[-1].shape[2] == 0
    G = rng.randn(1, 6, 8, 4 * 49).astype(np.float32)
    ref = _jax_grads(pyr, coords, 3, G, torch.float32)
    got = _port_grads(pyr, coords, 3, G, torch.float32)
    assert got[-1].shape == pyr[-1].shape
    for a, b in zip(got, ref):
        assert _max_rel(a, b) <= 2e-5


@pytest.mark.parametrize("radius", [3, 4])
def test_bwd_plain_matches_autograd_of_plain_lookup(radius):
    """The port's own oracle pair: K3's plain version against autograd through
    the plain forward (gathers), with a nonlinear loss."""
    pyr, coords, _ = _inputs(seed=10 + radius, B=2)
    tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
    tc = torch.from_numpy(coords)
    loss = torch.cos(ck.corr_pyramid_lookup_cuda(tp, tc, radius)).sum()
    got = torch.autograd.grad(loss, tp)
    loss_ref = torch.cos(corr_pyramid_lookup(tp, tc, radius)).sum()
    ref = torch.autograd.grad(loss_ref, tp)
    for a, b in zip(got, ref):
        assert _max_rel(a.numpy(), b.numpy()) <= 2e-5


def test_coords_get_no_gradient_and_cpu_launches_nothing():
    pyr, coords, rng = _inputs(seed=3)
    corr = torch.from_numpy(pyr[0]).requires_grad_()
    flat = torch.from_numpy(coords).reshape(1, -1, 2).contiguous().requires_grad_()
    ck.reset_launches()
    out = ck.LookupLevel.apply(corr, flat, 3, torch.float32)
    out.sum().backward()
    assert flat.grad is None and corr.grad is not None
    assert set(ck.LAUNCHES.values()) == {0}


def test_bwd_wrapper_checks():
    coords = torch.zeros(1, 5, 2)
    g = torch.zeros(1, 5, 49)
    assert ck.corr_lookup_level_bwd(coords, g, 0, 4, 3).shape == (1, 5, 0, 4)
    d = ck.corr_lookup_level_bwd(coords, g.bfloat16(), 3, 4, 3, torch.bfloat16)
    assert d.dtype == torch.bfloat16 and d.shape == (1, 5, 3, 4)
    with pytest.raises(ValueError):
        ck.corr_lookup_level_bwd(coords, torch.zeros(1, 5, 48), 3, 4, 3)
    with pytest.raises(ValueError):
        ck.corr_lookup_level_bwd(coords, torch.zeros(1, 49, 5).transpose(1, 2), 3, 4, 3)
    with pytest.raises(ValueError):
        ck.corr_lookup_level_bwd(coords.double(), g, 3, 4, 3)
    with pytest.raises(TypeError):
        ck.corr_lookup_level_bwd(coords, g, 3, 4, 3, torch.float16)


def test_fuse_coarse_refuses_gradients():
    pyr, coords, _ = _inputs(seed=4, levels=4, far=False)
    tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
    with pytest.raises(ValueError, match="forward only"):
        ck.corr_pyramid_lookup_cuda(tp, torch.from_numpy(coords), 3, fuse_coarse=True)
    with torch.no_grad():
        ck.corr_pyramid_lookup_cuda(tp, torch.from_numpy(coords), 3, fuse_coarse=True)
