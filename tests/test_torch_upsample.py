"""Upsampling, grids and padding: port against the JAX package, on the CPU.

Tolerance 1e-5 max abs: both sides run the same fp32 arithmetic (softmax and a
9-term sum for the convex upsample, one lerp per axis for the resize, with the
resize positions computed as the JAX package's compiled code computes them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.ops import grid as jgrid
from raft_optical_flow_tpu.ops import padding as jpad
from raft_optical_flow_tpu.ops import upsample as jup
from raft_optical_flow_tpu_torch.ops import grid as tgrid
from raft_optical_flow_tpu_torch.ops import padding as tpad
from raft_optical_flow_tpu_torch.ops import upsample as tup
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 8, 12)])
def test_convex_upsample_matches_jax(shape):
    rng = np.random.RandomState(0)
    N, h, w = shape
    flow = rng.randn(N, h, w, 2).astype(np.float32) * 3
    mask = rng.randn(N, h, w, 576).astype(np.float32) * 2
    ref = np.asarray(jup.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    out = tup.convex_upsample(_t(flow), _t(mask)).numpy()
    assert out.shape == ref.shape == (N, 8 * h, 8 * w, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 5), (2, 24, 40), (1, 1, 4)])
def test_upflow8_matches_jax(shape):
    flow = np.random.RandomState(1).randn(*shape, 2).astype(np.float32) * 4
    ref = np.asarray(jgrid.upflow8(jnp.asarray(flow)))
    out = tgrid.upflow8(_t(flow)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_resize_align_corners_matches_jax():
    img = np.random.RandomState(2).rand(2, 7, 9, 3).astype(np.float32)
    for hw in [(13, 5), (7, 20), (1, 9)]:
        ref = np.asarray(jgrid.resize_bilinear_align_corners(jnp.asarray(img), hw))
        out = tgrid.resize_bilinear_align_corners(_t(img), hw).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_coords_grid_matches_jax():
    ref = np.asarray(jgrid.coords_grid(2, 5, 7))
    out = tgrid.coords_grid(2, 5, 7, device="cpu").numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize(
    "kwargs",
    [{"mode": "sintel"}, {"mode": "kitti"}, {"mode": "sintel", "stride": 16}, {"mode": "kitti", "stride": 32}],
)
def test_input_padder_matches_jax(kwargs):
    img = np.random.RandomState(3).uniform(0, 255, (2, 37, 50, 3)).astype(np.float32)
    jp = jpad.InputPadder(img.shape, **kwargs)
    tp = tpad.InputPadder(img.shape, **kwargs)
    ref = np.asarray(jp.pad(jnp.asarray(img)))
    out = tp.pad(_t(img))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tp.unpad(out).numpy(), img)
    a, b = tp.pad(_t(img), _t(img))
    assert a.shape == b.shape == ref.shape


def test_input_padder_serving_shape():
    tp = tpad.InputPadder((1, 436, 1024, 3), mode="sintel")
    out = tp.pad(torch.zeros(1, 436, 1024, 3))
    assert tuple(out.shape) == (1, 440, 1024, 3)
