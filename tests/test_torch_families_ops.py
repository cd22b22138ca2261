"""The ops that SimpleFlowNet and IFNet add to the port, against the JAX
package's.

Tolerances:
  - `bilinear_sampler` in its border mode and `backward_warp` in both
    modes: 1e-6 * the largest value (the same taps and weights, sums in
    another order; the jitted JAX warp fuses the grid's add into its
    positions), gradients within 1e-6 (values) and 1e-5 (positions, whose
    terms cancel), at positions outside the image, on its edges and on its
    corners; `clip_jax` exactly, its gradient 0.5 at a bound as JAX's;
  - `correlation_layer`: fp32 within 1e-6 absolute (unit-norm features:
    every value lies in [-1, 1]), its gradients within 1e-5 of the largest,
    an all-zero feature vector included (zero rows, finite gradients); bf16
    within one bf16 step of JAX's value (both normalise and sum in fp32 and
    round once);
  - the PReLU: exact values, gradient 1 at x = 0 as JAX's (F.prelu's is
    the slope); bf16 exact;
  - the weight round trip of both goldens' params: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models import ifnet as jifnet
from raft_optical_flow_tpu.models import simple_flow as jsf
from raft_optical_flow_tpu.ops import grid as jgrid
from raft_optical_flow_tpu.ops import warp as jwarp
from raft_optical_flow_tpu_torch.models import IFNet, SimpleFlowNet
from raft_optical_flow_tpu_torch.models.layers import PReLU
from raft_optical_flow_tpu_torch.models.simple_flow import correlation_layer
from raft_optical_flow_tpu_torch.ops import grid, warp
from raft_optical_flow_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_checkpoint,
    state_dict_to_flax,
)
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_clip_jax_values_and_gradient_at_bounds():
    x = np.array([-2.0, 0.0, 0.5, 3.0, 4.0, 7.5], np.float32)
    xt = _t(x).requires_grad_(True)
    got = grid.clip_jax(xt, 0.0, 4.0)
    np.testing.assert_array_equal(got.detach().numpy(), np.clip(x, 0.0, 4.0))
    got.sum().backward()
    ref = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 4.0)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
    assert xt.grad[1] == 0.5 and xt.grad[4] == 0.5  # torch.clamp's would be 1


def test_abs_jax_gradient_at_zero():
    x = _t(np.array([-1.5, 0.0, 2.0], np.float32)).requires_grad_(True)
    grid.abs_jax(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.abs(a)))(jnp.asarray([-1.5, 0.0, 2.0]))))


def _edge_coords(rng, N, H, W, S):
    """Positions spread over and around the image, with some on its edges,
    its corners and exactly at pixel centres."""
    coords = np.stack([rng.uniform(-3, W + 2, (N, *S)), rng.uniform(-3, H + 2, (N, *S))], -1)
    coords = coords.astype(np.float32)
    coords[0, 0, :6] = [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.0, 0.0], [0.0, H - 1.0],
                        [-1.0, 2.0], [W + 0.5, H - 1.0]]
    coords[0, 1, :3] = [[1.0, 1.0], [0.5, H - 1.0], [W - 1.0, 0.25]]
    return coords


@pytest.mark.parametrize("hw", [(12, 17), (1, 9), (9, 1), (2, 2)])
def test_bilinear_sampler_border_matches_jax(hw):
    rng = np.random.RandomState(sum(hw))
    H, W = hw
    img = rng.randn(2, H, W, 5).astype(np.float32)
    coords = _edge_coords(rng, 2, H, W, (7, 6))
    ref, vjp = jax.vjp(jax.jit(lambda a, c: jgrid.bilinear_sampler(a, c, padding="border")),
                       jnp.asarray(img), jnp.asarray(coords))
    it, ct = _t(img).requires_grad_(True), _t(coords).requires_grad_(True)
    got = grid.bilinear_sampler(it, ct, padding="border")
    assert got.shape == ref.shape
    assert _max_rel(got.detach(), ref) <= 1e-6
    # a position outside takes the value of the nearest border position
    assert (got[0, 0, 4].detach().numpy() == img[0, min(2, H - 1), 0]).all()
    cot = rng.randn(*ref.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    g_img, g_coords = vjp(jnp.asarray(cot))
    assert _max_rel(it.grad, g_img) <= 1e-6
    assert _max_rel(ct.grad, g_coords) <= 1e-5
    # clipped coordinates get no gradient, on both sides
    outside = (coords[..., 0] < 0) | (coords[..., 0] > W - 1)
    assert (ct.grad[..., 0].numpy()[outside] == 0).all()


def test_bilinear_sampler_rejects_unknown_padding():
    with pytest.raises(ValueError):
        grid.bilinear_sampler(torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 2, 2), padding="reflect")


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_backward_warp_matches_jax(padding):
    rng = np.random.RandomState(7)
    N, H, W = 2, 10, 14
    img = rng.randn(N, H, W, 3).astype(np.float32)
    flow = rng.uniform(-4, 4, (N, H, W, 2)).astype(np.float32)
    # positions on the edges and corners, on pixel centres, and outside
    flow[0, 0, 0] = [0.0, 0.0]
    flow[0, 0, 5] = [W - 6.0, 0.0]
    flow[0, 4, 0] = [0.0, H - 5.0]
    flow[0, 5, 5] = [-6.5, -5.0]
    flow[0, 2, 2] = [-2.5, 1.0]
    flow[1, 9, 13] = [3.0, 0.5]
    flow[1, 3, 3] = [1.0, 2.0]
    ref, vjp = jax.vjp(jax.jit(lambda a, f: jwarp.backward_warp(a, f, padding=padding)),
                       jnp.asarray(img), jnp.asarray(flow))
    it, ft = _t(img).requires_grad_(True), _t(flow).requires_grad_(True)
    got = warp.backward_warp(it, ft, padding=padding)
    assert got.shape == ref.shape == (N, H, W, 3)
    assert _max_rel(got.detach(), ref) <= 1e-6
    assert (got[0, 0, 0].detach().numpy() == img[0, 0, 0]).all()
    assert (got[0, 0, 5].detach().numpy() == img[0, 0, W - 1]).all()
    assert (got[0, 4, 0].detach().numpy() == img[0, H - 1, 0]).all()
    if padding == "border":
        assert (got[0, 2, 2].detach().numpy() == img[0, 3, 0]).all()
        assert (got[1, 9, 13].detach().numpy() == img[1, H - 1, W - 1]).all()
        assert (got[0, 5, 5].detach().numpy() == img[0, 0, 0]).all()
    else:
        assert (got[0, 5, 5] == 0).all()
    cot = rng.randn(*ref.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    g_img, g_flow = vjp(jnp.asarray(cot))
    assert _max_rel(it.grad, g_img) <= 1e-6
    assert _max_rel(ft.grad, g_flow) <= 1e-5


def test_flow_to_warp_keeps_fp32_coords():
    flow = np.random.RandomState(8).uniform(-2, 2, (1, 3, 600, 2)).astype(np.float32)
    got = warp.flow_to_warp(_t(flow).bfloat16())
    assert got.dtype == torch.float32
    ref = jwarp.flow_to_warp(jnp.asarray(flow, jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a bf16 grid would round x ~ 599 to a multiple of 4
    assert (got[..., 0].numpy() % 4 != 0).any()


def _features(seed, shape=(2, 9, 13, 16)):
    rng = np.random.RandomState(seed)
    a = np.maximum(rng.randn(*shape), 0).astype(np.float32)  # post-ReLU features
    b = np.maximum(rng.randn(*shape), 0).astype(np.float32)
    a[0, 3, 4] = 0.0  # all-zero vectors, in f1 and in f2
    b[1, 5, 6] = 0.0
    b[0, 3, 4] = 0.0
    return a, b


@pytest.mark.parametrize("r", [4, 2])
def test_correlation_layer_matches_jax(r):
    a, b = _features(r)
    fn = jax.jit(jsf.correlation_layer, static_argnums=2)
    ref, vjp = jax.vjp(lambda x, y: fn(x, y, r), jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    got = correlation_layer(at, bt, r)
    assert got.shape == ref.shape == (2, 9, 13, (2 * r + 1) ** 2)
    assert np.abs(got.detach().numpy() - np.asarray(ref)).max() <= 1e-6
    assert (got[0, 3, 4] == 0).all()
    # channel k = (dy + r)(2r + 1) + (dx + r) holds <f1(x), f2(x - (dx, dy))>
    n1 = a[1, 4, 6] / np.linalg.norm(a[1, 4, 6])
    dy, dx = 1, -2
    n2 = b[1, 4 - dy, 6 - dx] / np.linalg.norm(b[1, 4 - dy, 6 - dx])
    assert abs(float(got.detach()[1, 4, 6, (dy + r) * (2 * r + 1) + dx + r]) - float(n1 @ n2)) <= 1e-6
    cot = np.random.RandomState(9).randn(*ref.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    ga, gb = vjp(jnp.asarray(cot))
    assert np.isfinite(at.grad.numpy()).all() and np.isfinite(bt.grad.numpy()).all()
    assert _max_rel(at.grad, ga) <= 1e-5
    assert _max_rel(bt.grad, gb) <= 1e-5


def test_correlation_layer_bf16_matches_jax():
    a, b = _features(3)
    ref = jax.jit(jsf.correlation_layer)(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    got = correlation_layer(_t(a).bfloat16(), _t(b).bfloat16())
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    r = np.asarray(ref.astype(jnp.float32))
    assert (np.abs(got.float().numpy() - r) <= np.abs(r) * 2.0 ** -8 + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prelu_matches_jax(dtype):
    rng = np.random.RandomState(10)
    x = rng.randn(2, 5, 4, 6).astype(np.float32)  # NHWC
    x[0, 0, 0] = 0.0
    slope = rng.uniform(0.05, 0.5, 6).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref, vjp = jax.vjp(lambda v: jifnet.PReLU().apply({"params": {"scale": jnp.asarray(slope)}}, v),
                       jnp.asarray(x, jdt))
    mod = PReLU(6)
    with torch.no_grad():
        mod.weight.copy_(_t(slope))
    xt = _t(x).to(dtype).permute(0, 3, 1, 2).requires_grad_(True)
    got = mod(xt)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.detach().float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    if dtype == torch.float32:
        got.sum().backward()
        g = np.asarray(vjp(jnp.ones_like(ref))[0])
        np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(), g)
        assert (xt.grad[0, :, 0, 0] == 1).all()  # F.prelu's would be the slope


@pytest.mark.parametrize("name,cls", [("simple_flow", SimpleFlowNet), ("ifnet", IFNet)])
def test_weight_round_trip(name, cls):
    """The goldens' params (and SimpleFlowNet's batch_stats) load into the
    port strictly and come back unchanged; IFNet's transposed-conv kernel
    (4, 4, 5, c) lands on torch's (c, 5, 4, 4)."""
    tree = load_flax_checkpoint(os.path.join(GOLDENS, f"{name}_params.npz"))
    model = cls(device="cpu")
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    back = state_dict_to_flax(model.state_dict())

    def flat(t, pre=()):
        for k, v in t.items():
            yield from flat(v, pre + (k,)) if isinstance(v, dict) else [(pre + (k,), v)]

    a, b = dict(flat(tree)), dict(flat(back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))
    if name == "ifnet":
        assert tuple(model.block0.lastconv.weight.shape) == (240, 5, 4, 4)
        assert tuple(model.block2.conv0_1_1.weight.shape) == (90,)
    else:
        assert "feature_extractor.res_block4.shortcut_1.running_var" in model.state_dict()
