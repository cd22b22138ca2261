"""The align-corners resize behind `upflow8`: a selection product, no gather.

The resize takes its two taps per output position from one product with a
fixed one-hot matrix, so neither its forward nor its backward gathers or
scatters (the backward of a gather adds with atomics on the card, and two
identical training steps then differ). Held here against the gather
formulation it replaced and against the JAX package's compiled `upflow8`,
the values equal to the gather form's bit for bit and its gradient within
1e-6 of the largest gradient (only its sums differ in order); against JAX,
values and gradients within 1e-6 of the largest (XLA's compiled lerp may
fuse a multiply-add, a few ulps of an output of 10 px). The positions
are those of the JAX package's compiled `jnp.linspace`, checked here at
the sizes whose positions the older `i * fl(stop / (num - 1))` form missed
by one ulp (8 -> 64, 12 -> 96, 46 -> 368, 62 -> 496).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.ops import grid as jgrid
from raft_optical_flow_tpu_torch.ops import grid as tgrid


def _gather_resize_axis(x, out_size, axis):
    """The gather formulation the port used before (index_select of lo, hi)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size == 1:
        reps = [1] * x.dim()
        reps[axis] = out_size
        return x.repeat(reps)
    pos = tgrid._linspace_to(in_size - 1.0, out_size, x.device)
    i0 = torch.floor(pos).long().clamp(0, in_size - 2)
    w = (pos - i0.float()).to(x.dtype)
    lo = torch.index_select(x, axis, i0)
    hi = torch.index_select(x, axis, i0 + 1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w.reshape(shape)
    return lo * (1 - w) + hi * w


def _gather_upflow8(flow):
    _, h, w, _ = flow.shape
    x = _gather_resize_axis(flow, 8 * h, 1)
    return 8.0 * _gather_resize_axis(x, 8 * w, 2)


def _graph_ops(t):
    seen, names, stack = set(), set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.add(type(fn).__name__)
        stack += [f for f, _ in fn.next_functions]
    return names


@pytest.mark.parametrize("shape", [(1, 3, 5), (2, 8, 12), (1, 1, 4), (2, 24, 40)])
def test_upflow8_matches_gather_form_and_jax(shape):
    rng = np.random.RandomState(sum(shape))
    flow = rng.randn(*shape, 2).astype(np.float32)
    G = rng.randn(shape[0], 8 * shape[1], 8 * shape[2], 2).astype(np.float32)
    x = torch.from_numpy(flow).requires_grad_()
    out = tgrid.upflow8(x)
    assert "IndexSelectBackward0" not in _graph_ops(out)
    assert not any("Index" in n or "Gather" in n or "Scatter" in n for n in _graph_ops(out))
    (grad,) = torch.autograd.grad((out * torch.from_numpy(G)).sum(), x)

    x_ref = torch.from_numpy(flow).requires_grad_()
    ref = _gather_upflow8(x_ref)
    (grad_ref,) = torch.autograd.grad((ref * torch.from_numpy(G)).sum(), x_ref)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=0, atol=1e-6 * max(
        1.0, float(grad_ref.abs().max())))

    jflow = jnp.asarray(flow)
    jref = np.asarray(jax.jit(jgrid.upflow8)(jflow))  # compiled, as the model runs it
    np.testing.assert_allclose(out.detach().numpy(), jref, rtol=0,
                               atol=1e-6 * float(np.abs(jref).max()))
    jgrad = np.asarray(jax.jit(jax.grad(lambda f: jnp.sum(jgrid.upflow8(f) * G)))(jflow))
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=1e-6 * max(
        1.0, float(np.abs(jgrad).max())))


@pytest.mark.parametrize("n,m", [(8, 64), (12, 96), (46, 368), (62, 496), (24, 192), (55, 440)])
def test_positions_match_compiled_jax_linspace(n, m):
    ref = np.asarray(jax.jit(lambda: jnp.linspace(0.0, n - 1.0, m, dtype=jnp.float32))())
    np.testing.assert_array_equal(tgrid._linspace_to(n - 1.0, m, "cpu").numpy(), ref)


def test_resize_is_a_product_in_both_directions():
    img = torch.from_numpy(np.random.RandomState(4).rand(2, 7, 9, 3).astype(np.float32))
    img.requires_grad_()
    out = tgrid.resize_bilinear_align_corners(img, (13, 20))
    ops = _graph_ops(out)
    assert not any("Index" in n or "Gather" in n or "Scatter" in n for n in ops), ops
    np.testing.assert_array_equal(
        out.detach().numpy(),
        _gather_resize_axis(_gather_resize_axis(img.detach(), 13, 1), 20, 2).numpy())
