"""The rest of the ops surface against the JAX package's ops, on seeded
numpy inputs: the all-pairs volume and its pooled pyramid, `upflow_n`, the
nearest sampler, the sampler's and the warp's in-bounds masks, the forward
splats with their gradients, the translated spatial correlation, and
`InputPadder`'s LiteFlowNet3 options. One jit of the JAX side for the file.

Tolerances:
  - fp32 values: max abs 1e-5 against the jitted JAX function (sums in
    another order);
  - masks, nearest samples and padding: exact;
  - the splats: within 1e-5 of JAX's float scatter, and within the stated
    fixed-point bound (n * 2^-(bits+1) per element of n contributions,
    plus the fp32 roundings of each weight times value and of the sum) of
    the exact sum in float64;
  - the splats' gradients with respect to the image and the flow: max_rel
    2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_optical_flow_tpu.ops as jops
import raft_optical_flow_tpu_torch.ops as tops
from raft_optical_flow_tpu.ops import grid as jgrid
from raft_optical_flow_tpu_torch.ops import warp as twarp
from torch_threads import one_torch_thread  # noqa: F401

B, H, W, C = 2, 12, 16, 5
PADDERS = (
    dict(dims=(B, 13, 21, 3)),
    dict(dims=(B, 13, 21, 3), mode="kitti"),
    dict(dims=(B, 13, 21, 3), stride=32, pad_mode="constant", pad_value=-1.5),
    dict(dims=(B, 13, 21, 3), stride=16, two_side_pad=False),
    dict(dims=(B, 13, 21, 3), fixed_size=(20, 24), pad_mode="constant"),
    dict(dims=(B, 13, 21, 3), fixed_size=(16, 32), two_side_pad=False),
)
PATCHES = ((3, 1), (5, 2))


def _inputs():
    rng = np.random.default_rng(16)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    # positions on the edges, on half pixels, far outside and inside
    coords = rng.uniform(-3, W + 2, size=(B, H, W, 2)).astype(np.float32)
    coords[0, 0, :6, 0] = [0.0, W - 1.0, 2.5, 3.5, -0.5, W - 0.5]
    coords[0, 0, :6, 1] = [H - 1.0, 0.0, 4.5, 1.5, 0.5, -7.0]
    flow = rng.uniform(-4, 4, size=(B, H, W, 2)).astype(np.float32)
    flow[1, 3, :4] = [[0.0, 0.0], [1.0, -2.0], [-1.0, 0.5], [W - 1.0, 0.0]]  # whole pixels
    return {
        "fmap1": f(B, H, W, 24), "fmap2": f(B, H, W, 24),
        "img": f(B, H, W, C), "coords": coords, "flow": flow,
        "flow_small": f(B, 3, 4, 2), "cot": f(B, H, W, C), "cot1": f(B, H, W, 1),
        "in1": f(B, H, W, 8), "in2": f(B, H, W, 8),
        "frames": rng.uniform(0, 255, size=(B, 13, 21, 3)).astype(np.float32),
    }


def _jax_reference(x):
    out = {}
    corr = jops.all_pairs_correlation(x["fmap1"], x["fmap2"])
    out["corr"] = corr
    out["pyramid"] = jops.build_corr_pyramid(corr, 4)
    out["upflow4"] = jgrid.upflow_n(x["flow_small"], 4)
    out["upflow3"] = jgrid.upflow_n(x["flow_small"], 3)
    out["nearest"] = jops.grid_sample_nearest(x["img"], x["coords"])
    for pad in ("zeros", "border"):
        out[f"sample_{pad}"] = jops.bilinear_sampler(x["img"], x["coords"], padding=pad,
                                                     return_mask=True)
        out[f"warp_{pad}"] = jops.backward_warp(x["img"], x["flow"], padding=pad,
                                                return_mask=True)

    def splat_loss(img, flow):
        return jnp.vdot(jops.forward_splat(img, flow), x["cot"])

    def range_loss(flow):
        return jnp.vdot(jops.forward_splat_range_map(flow), x["cot1"])

    out["splat"] = jops.forward_splat(x["img"], x["flow"])
    out["splat_grad"] = jax.grad(splat_loss, argnums=(0, 1))(x["img"], x["flow"])
    out["range"] = jops.forward_splat_range_map(x["flow"])
    out["range_grad"] = jax.grad(range_loss)(x["flow"])
    for p, d in PATCHES:
        out[f"tcorr_{p}_{d}"] = jops.translated_spatial_correlation_sample(
            x["in1"], x["in2"], x["flow"], p, d)
    out["pads"] = [jops.InputPadder(**kw).pad(x["frames"]) for kw in PADDERS]
    return out


@pytest.fixture(scope="module")
def case():
    x = _inputs()
    ref = jax.jit(_jax_reference)({k: jnp.asarray(v) for k, v in x.items()})
    return {k: torch.from_numpy(v) for k, v in x.items()}, jax.tree.map(np.asarray, ref)


def _close(got, ref, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape, got.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _max_rel(got, ref):
    return float(np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max())


def test_all_pairs_correlation_and_pyramid(case):
    x, ref = case
    corr = tops.all_pairs_correlation(x["fmap1"], x["fmap2"])
    _close(corr, ref["corr"])
    pyr = tops.build_corr_pyramid(corr, 4)
    assert len(pyr) == 4
    for got, want in zip(pyr, ref["pyramid"]):
        _close(got, want)
    # the per-level products of the model path give the same pyramid
    for got, want in zip(tops.build_corr_pyramid_from_fmaps(x["fmap1"], x["fmap2"], 4),
                         ref["pyramid"]):
        _close(got, want)


@pytest.mark.parametrize("factor", [3, 4])
def test_upflow_n(case, factor):
    x, ref = case
    _close(tops.upflow_n(x["flow_small"], factor), ref[f"upflow{factor}"])


def test_grid_sample_nearest_rounds_half_to_even_exactly(case):
    x, ref = case
    got = tops.grid_sample_nearest(x["img"], x["coords"])
    np.testing.assert_array_equal(got.numpy(), ref["nearest"])
    # 2.5 -> 2 and 3.5 -> 4 on both axes: half to even, as jnp.round
    np.testing.assert_array_equal(got[0, 0, 2].numpy(), x["img"][0, 4, 2].numpy())
    np.testing.assert_array_equal(got[0, 0, 3].numpy(), x["img"][0, 2, 4].numpy())


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_bilinear_sampler_and_backward_warp_masks(case, padding):
    x, ref = case
    out, mask = tops.bilinear_sampler(x["img"], x["coords"], padding=padding, return_mask=True)
    _close(out, ref[f"sample_{padding}"][0])
    np.testing.assert_array_equal(mask.numpy(), ref[f"sample_{padding}"][1])
    # the open interval: positions on the edges are outside
    if padding == "zeros":
        assert mask[0, 0, :2].tolist() == [0.0, 0.0]
    out, mask = tops.backward_warp(x["img"], x["flow"], padding=padding, return_mask=True)
    _close(out, ref[f"warp_{padding}"][0])
    np.testing.assert_array_equal(mask.numpy(), ref[f"warp_{padding}"][1])


def _splat_exact(img, flow):
    """forward_splat in float64 numpy at the fp32 positions grid + flow:
    (the exact sums, the contributions per element, their sums of |w v|)."""
    img = img.astype(np.float64)
    out, mag = np.zeros_like(img), np.zeros_like(img)
    n = np.zeros(img.shape[:3] + (1,))
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    for b in range(B):
        x = (gx + flow[b, ..., 0]).ravel().astype(np.float64)
        y = (gy + flow[b, ..., 1]).ravel().astype(np.float64)
        x0, y0 = np.floor(x), np.floor(y)
        wx, wy = x - x0, y - y0
        v = img[b].reshape(-1, C)
        for dx, dy, w in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                          (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
            xi, yi = (x0 + dx).astype(int), (y0 + dy).astype(int)
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            np.add.at(out[b], (yi[ok], xi[ok]), w[ok, None] * v[ok])
            np.add.at(mag[b], (yi[ok], xi[ok]), np.abs(w[ok, None] * v[ok]))
            np.add.at(n[b], (yi[ok], xi[ok]), 1)
    return out, n, mag


def test_forward_splat_values_within_the_bound_and_gradients(case):
    x, ref = case
    img = x["img"].clone().requires_grad_(True)
    flow = x["flow"].clone().requires_grad_(True)
    out = tops.forward_splat(img, flow)
    _close(out, ref["splat"])
    exact, n, mag = _splat_exact(x["img"].numpy(), x["flow"].numpy())
    # the stated bound: n * 2^-(bits+1) for the fixed point, at bits no more
    # than the call's (a row's sum of |w v| is at most its sum of |v|); plus
    # two fp32 roundings of each w * v and the last rounding to fp32
    bits = twarp.splat_bits(x["img"].abs().reshape(B, -1, C))
    assert bits > 30
    bound = n * 2.0**-(bits + 1) + mag * 2.0**-23 + np.abs(exact) * 2.0**-24
    assert (np.abs(out.detach().numpy() - exact) <= bound).all()
    (out * x["cot"]).sum().backward()
    g_img, g_flow = ref["splat_grad"]
    assert _max_rel(img.grad, g_img) <= 2e-5
    assert _max_rel(flow.grad, g_flow) <= 2e-5


def test_forward_splat_range_map_and_its_flow_gradient(case):
    x, ref = case
    flow = x["flow"].clone().requires_grad_(True)
    out = tops.forward_splat_range_map(flow)
    _close(out, ref["range"])
    (out * x["cot1"]).sum().backward()
    assert _max_rel(flow.grad, ref["range_grad"]) <= 2e-5


def test_forward_splat_is_the_same_twice_and_refuses_non_finite_values():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.normal(size=(1, 6, 7, 2)).astype(np.float32)) * 1e6
    flow = torch.from_numpy(rng.uniform(-2, 2, size=(1, 6, 7, 2)).astype(np.float32))
    assert torch.equal(tops.forward_splat(img, flow), tops.forward_splat(img, flow))
    img[0, 2, 3, 1] = float("inf")
    with pytest.raises(ValueError, match="not all finite"):
        tops.forward_splat(img, flow)


@pytest.mark.parametrize("patch,dilation", PATCHES)
def test_translated_spatial_correlation_sample(case, patch, dilation):
    x, ref = case
    got = tops.translated_spatial_correlation_sample(x["in1"], x["in2"], x["flow"], patch,
                                                     dilation)
    _close(got, ref[f"tcorr_{patch}_{dilation}"])


@pytest.mark.parametrize("i", range(len(PADDERS)))
def test_input_padder_options_exact(case, i):
    x, ref = case
    padder = tops.InputPadder(**PADDERS[i])
    got = padder.pad(x["frames"])
    np.testing.assert_array_equal(got.numpy(), ref["pads"][i])
    assert got.is_contiguous()
    np.testing.assert_array_equal(padder.unpad(got).numpy(), x["frames"].numpy())


def test_ops_exports_every_name_of_the_jax_package():
    assert set(jops.__all__) <= set(tops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
