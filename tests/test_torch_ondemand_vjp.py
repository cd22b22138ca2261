"""The on-demand correlation's backward (the plain versions of K5 and K6)
and its autograd Function against the JAX package, on the CPU.

The reference is `jax.grad` of `sum(out * G)` through the JAX package's
oracle `_ondemand_xla` (autodiff of gather sampling) and through its
dispatcher `ondemand_corr_pyramid(impl='xla')` (the blockwise custom VJP),
with the same numpy cotangent G on both sides. Tolerance: max_rel = max|d|
/ max|ref| <= 2e-5 for df1 and for each df2_l, the repo's fp32 VJP gate
(utils/grad_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.corr_ondemand import _ondemand_xla, ondemand_corr_pyramid
from raft_optical_flow_tpu.ops.corr import avg_pool2x2
from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(seed, B=2, H=10, W=12, C=16, levels=3):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    pyr = [jnp.asarray(rng.randn(B, H, W, C).astype(np.float32))]
    for _ in range(levels - 1):
        pyr.append(avg_pool2x2(pyr[-1].transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1))
    gy, gx = np.mgrid[0:H, 0:W]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-4, 4, coords.shape).astype(np.float32)
    coords[:, 0, :3] += 1.0e6  # far out of bounds: no gradient at all
    return f1, [np.array(p) for p in pyr], coords, rng


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if ref.size == 0:
        assert got.shape == ref.shape
        return 0.0
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _jax_grads(fn, f1, pyr, coords, radius, G, **kw):
    def loss(a, b):
        return jnp.sum(fn(a, b, jnp.asarray(coords), radius, **kw) * G)

    g1, g2 = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(f1), tuple(jnp.asarray(p) for p in pyr))
    return np.asarray(g1), [np.asarray(g) for g in g2]


def _port_grads(f1, pyr, coords, radius, G):
    t1 = torch.from_numpy(f1).requires_grad_()
    tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
    out = co.ondemand_corr_pyramid_cuda(t1, tp, torch.from_numpy(coords), radius)
    (out * torch.from_numpy(G)).sum().backward()
    return t1.grad.numpy(), [p.grad.numpy() for p in tp]


@pytest.mark.parametrize("oracle", ["ondemand_xla", "dispatcher_xla"])
@pytest.mark.parametrize("radius", [3, 4])
def test_plain_backward_matches_jax_grad(radius, oracle):
    f1, pyr, coords, rng = _inputs(seed=radius)
    K2 = (2 * radius + 1) ** 2
    G = rng.randn(*coords.shape[:3], len(pyr) * K2).astype(np.float32)
    if oracle == "ondemand_xla":
        ref1, ref2 = _jax_grads(_ondemand_xla, f1, pyr, coords, radius, G)
    else:
        ref1, ref2 = _jax_grads(ondemand_corr_pyramid, f1, pyr, coords, radius, G, impl="xla")
    got1, got2 = _port_grads(f1, pyr, coords, radius, G)
    assert _max_rel(got1, ref1) <= 2e-5, _max_rel(got1, ref1)
    for lvl, (a, b) in enumerate(zip(got2, ref2)):
        assert _max_rel(a, b) <= 2e-5, (lvl, _max_rel(a, b))
    assert np.all(got1[:, 0, :3] == 0)


def test_backward_with_an_empty_level():
    """A 6x8 crop: the deepest of four levels is empty; its gradient is an
    empty tensor and the other levels still match."""
    f1, pyr, coords, rng = _inputs(seed=8, B=1, H=6, W=8, levels=4)
    assert pyr[-1].shape[1] == 0
    G = rng.randn(1, 6, 8, 4 * 49).astype(np.float32)
    ref1, ref2 = _jax_grads(_ondemand_xla, f1, pyr, coords, 3, G)
    got1, got2 = _port_grads(f1, pyr, coords, 3, G)
    assert got2[-1].shape == pyr[-1].shape
    assert _max_rel(got1, ref1) <= 2e-5
    for a, b in zip(got2, ref2):
        assert _max_rel(a, b) <= 2e-5


def test_function_and_plain_route_agree_and_launch_nothing():
    """On the CPU `OndemandCorr` (the kernels' wrappers) and the plain route
    are one function: same values and gradients; bf16 inputs get bf16
    gradients; coords get none."""
    f1, pyr, coords, _ = _inputs(seed=4, levels=2)
    co.reset_launches()
    grads = []
    for fn in (co.ondemand_corr_pyramid_cuda, co.ondemand_corr_pyramid_plain):
        t1 = torch.from_numpy(f1).requires_grad_()
        tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
        tc = torch.from_numpy(coords).requires_grad_()
        out = fn(t1, tp, tc, 3)
        torch.cos(out).sum().backward()
        assert tc.grad is None
        grads.append([out.detach(), t1.grad] + [p.grad for p in tp])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(co.LAUNCHES.values()) == {0}
    t1 = torch.from_numpy(f1).bfloat16().requires_grad_()
    tp = [torch.from_numpy(p).bfloat16().requires_grad_() for p in pyr]
    out = co.ondemand_corr_pyramid_cuda(t1, tp, torch.from_numpy(coords), 3, torch.bfloat16)
    out.float().square().sum().backward()
    assert out.dtype == t1.grad.dtype == tp[1].grad.dtype == torch.bfloat16


def test_checkpoint_recomputes_the_function():
    """Non-reentrant checkpointing (RAFTConfig.remat) composes with the
    Function: the forward runs again in the backward, gradients equal."""
    from torch.utils.checkpoint import checkpoint

    f1, pyr, coords, _ = _inputs(seed=5, B=1, levels=2)
    grads = []
    for remat in (False, True):
        t1 = torch.from_numpy(f1).requires_grad_()
        tp = [torch.from_numpy(p).requires_grad_() for p in pyr]
        tc = torch.from_numpy(coords)

        def f(a, b, c):
            return torch.sin(co.ondemand_corr_pyramid_cuda(a, [b, c], tc, 3))

        out = checkpoint(f, t1, *tp, use_reentrant=False) if remat else f(t1, *tp)
        out.sum().backward()
        grads.append([t1.grad] + [p.grad for p in tp])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
