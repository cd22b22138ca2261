"""The ops of the port's LiteFlowNet3 path against the JAX package's.

Tolerances:
  - the half-pixel bilinear resize: 2e-6 * max|x| (JAX sums weighted taps,
    torch interpolates: they round differently), gradients likewise;
  - the nearest resize's rows: equal to JAX's compiled
    `jax.image.resize(method="nearest")` over 441 size pairs, 436 -> 109
    among them (torch's 'nearest' and 'nearest-exact' both miss there);
  - `bilinear_sampler`, `warp_lfn3`, the transposed conv: 1e-6 * the
    largest value (the same taps and weights, sums in another order; the
    jitted JAX warp fuses a multiply-add into its positions), gradients
    within 1e-6 (values) and 1e-5 (positions, whose terms cancel); the
    warp's mask exactly, also at positions on the box's edges;
  - the correlations: fp32 within 1e-5 * max|ref| (C-long sums in another
    order); bf16 within one bf16 step of JAX's value (both sum in fp32 and
    round once);
  - the weight round trip: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.models import layers as jlayers
from raft_optical_flow_tpu.models.liteflownet3 import LFN3Config as JaxLFN3Config
from raft_optical_flow_tpu.models.liteflownet3 import LiteFlowNet3 as JaxLiteFlowNet3
from raft_optical_flow_tpu.ops import grid as jgrid
from raft_optical_flow_tpu.ops import padding as jpadding
from raft_optical_flow_tpu.ops import spatial_corr as jcorr
from raft_optical_flow_tpu.ops import warp as jwarp
from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3
from raft_optical_flow_tpu_torch.models import layers
from raft_optical_flow_tpu_torch.ops import grid, padding, spatial_corr, warp
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


@pytest.mark.parametrize("src,dst", [((64, 96), (16, 24)), ((50, 70), (64, 96)),
                                     ((64, 96), (50, 70)), ((16, 24), (64, 96)),
                                     ((36, 32), (7, 13))])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.RandomState(sum(src) + sum(dst))
    x = rng.randn(2, *src, 3).astype(np.float32)
    ref, vjp = jax.vjp(jax.jit(lambda a: jgrid.resize_bilinear(a, dst)), jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = grid.resize_bilinear(xt, dst)
    assert got.shape == ref.shape
    assert _max_rel(got.detach(), ref) <= 2e-6
    ct = rng.randn(*ref.shape).astype(np.float32)
    (got * _t(ct)).sum().backward()
    assert _max_rel(xt.grad, vjp(jnp.asarray(ct))[0]) <= 2e-6


def _jax_nearest_rows(pairs):
    """JAX's nearest rows for each (in, out) pair: one compile of all the
    resizes, each of a slice of an argument (a constant input would be
    folded by XLA's evaluator, not by the compiled graph)."""
    resize = jax.jit(lambda x: [jax.image.resize(x[:m], (n,), method="nearest")
                                for m, n in pairs])
    rows = resize(jnp.arange(max(m for m, _ in pairs), dtype=jnp.float32))
    return [np.asarray(r).astype(np.int64) for r in rows]


def test_nearest_rows_match_jax():
    rng = np.random.RandomState(0)
    pairs = [(436, 109), (64, 16), (368, 92), (496, 124), (1024, 256), (50, 13), (70, 18)]
    pairs += [(m, n) for m in range(2, 40, 3) for n in range(1, 40, 2)]
    pairs += [(int(m), int(n)) for m, n in zip(rng.randint(40, 1100, 174), rng.randint(5, 300, 174))]
    assert len(pairs) == 441
    ref = _jax_nearest_rows(pairs)
    bad = [(m, n) for (m, n), r in zip(pairs, ref)
           if not np.array_equal(grid.nearest_indices(m, n, "cpu").numpy(), r)]
    assert not bad, bad
    # torch's own nearest modes pick other rows at 436 -> 109
    x = torch.arange(436, dtype=torch.float32)[None, None, :, None]
    for mode in ("nearest", "nearest-exact"):
        rows = torch.nn.functional.interpolate(x, size=(109, 1), mode=mode)[0, 0, :, 0]
        assert (rows.long().numpy() != ref[0]).all()


@pytest.mark.parametrize("shape,out_hw", [((2, 436, 64, 1), (109, 16)), ((1, 64, 96, 1), (16, 24)),
                                          ((2, 50, 70, 2), (13, 18))])
def test_resize_nearest_matches_jax(shape, out_hw):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (shape[0], *out_hw, shape[3]), method="nearest")
    np.testing.assert_array_equal(grid.resize_nearest(_t(x), out_hw).numpy(), np.asarray(ref))


@pytest.mark.parametrize("hw", [(12, 17), (1, 9), (9, 1)])
def test_bilinear_sampler_matches_jax(hw):
    rng = np.random.RandomState(3)
    H, W = hw
    img = rng.randn(2, H, W, 5).astype(np.float32)
    coords = np.stack([rng.uniform(-2, W + 1, (2, 7, 6)),
                       rng.uniform(-2, H + 1, (2, 7, 6))], -1).astype(np.float32)
    coords[0, 0, :4] = [[0.0, 0.0], [W - 1.0, H - 1.0], [3.0, 0.5], [W - 1.0, 0.0]]
    ref, vjp = jax.vjp(jax.jit(lambda a, c: jgrid.bilinear_sampler(a, c, padding="zeros")),
                       jnp.asarray(img), jnp.asarray(coords))
    it, ct = _t(img).requires_grad_(True), _t(coords).requires_grad_(True)
    got = grid.bilinear_sampler(it, ct)
    assert got.shape == ref.shape
    assert _max_rel(got.detach(), ref) <= 1e-6
    cot = rng.randn(*ref.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    g_img, g_coords = vjp(jnp.asarray(cot))
    assert _max_rel(it.grad, g_img) <= 1e-6
    assert _max_rel(ct.grad, g_coords) <= 1e-5


def test_bilinear_sampler_bf16_rounds_weights():
    """Under the bf16 policy the four weights are rounded to the image's
    dtype, as the JAX package does: the same bits as JAX on the CPU."""
    rng = np.random.RandomState(4)
    img = rng.randn(1, 9, 11, 4).astype(np.float32)
    coords = np.stack([rng.uniform(-1, 11, (1, 5, 5)), rng.uniform(-1, 9, (1, 5, 5))], -1)
    coords = coords.astype(np.float32)
    ref = jax.jit(jgrid.bilinear_sampler)(jnp.asarray(img, jnp.bfloat16), jnp.asarray(coords))
    got = grid.bilinear_sampler(_t(img).bfloat16(), _t(coords))
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    step = np.abs(ref32) * 2.0 ** -8 + 1e-30
    assert (np.abs(got.float().numpy() - ref32) <= step).all()


@pytest.mark.parametrize("div_flow", [1.0, 1.6])
def test_warp_lfn3_matches_jax(div_flow):
    rng = np.random.RandomState(5)
    N, H, W = 2, 10, 14
    x = rng.randn(N, H, W, 3).astype(np.float32)
    flow = rng.uniform(-3, 3, (N, H, W, 2)).astype(np.float32) * div_flow
    # positions exactly on the box's edges (flows whose quotient by div_flow
    # is exact: XLA computes grid + flow * (1 / div_flow) as one fused
    # multiply-add, the port rounds the product first), and just outside
    flow[0, 0, 0] = [0.0, 0.0]
    flow[0, 0, 8] = [8.0, 0.0] if div_flow != 1.0 else [5.0, 0.0]
    flow[0, 4, 0] = [0.0, 8.0] if div_flow != 1.0 else [0.0, 5.0]
    flow[0, 5, 5] = [-8.0, -8.0] if div_flow != 1.0 else [-5.0, -5.0]
    flow[0, 2, 2] = [-2.001 * div_flow, 0.0]
    flow[1, 9, 13] = [0.0, 0.001 * div_flow]
    ref, vjp = jax.vjp(jax.jit(lambda a, f: jwarp.warp_lfn3(a, f, div_flow)),
                       jnp.asarray(x), jnp.asarray(flow))
    xt, ft = _t(x).requires_grad_(True), _t(flow).requires_grad_(True)
    got = warp.warp_lfn3(xt, ft, div_flow)
    assert _max_rel(got.detach(), ref) <= 1e-6
    np.testing.assert_array_equal(got.detach().numpy() == 0, np.asarray(ref) == 0)
    for i, j, src in ((0, 0, (0, 0)), (0, 8, (0, 13)), (4, 0, (9, 0)), (5, 5, (0, 0))):
        assert (got[0, i, j].detach().numpy() == x[0, src[0], src[1]]).all()
    assert (got[0, 2, 2] == 0).all() and (got[1, 9, 13] == 0).all()
    cot = rng.randn(*ref.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    g_x, g_f = vjp(jnp.asarray(cot))
    assert _max_rel(xt.grad, g_x) <= 1e-6
    assert _max_rel(ft.grad, g_f) <= 1e-5


def test_warp_lfn3_bf16_keeps_fp32_coords():
    rng = np.random.RandomState(6)
    x = rng.randn(1, 6, 40, 8).astype(np.float32)
    flow = rng.uniform(-2, 2, (1, 6, 40, 2)).astype(np.float32)
    ref = jax.jit(jwarp.warp_lfn3)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(flow, jnp.bfloat16))
    got = warp.warp_lfn3(_t(x).bfloat16(), _t(flow).bfloat16())
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    assert (np.abs(got.float().numpy() - ref32) <= np.abs(ref32) * 2.0 ** -8 + 1e-30).all()


@pytest.mark.parametrize("patch,dilation", [(5, 2), (7, 2), (9, 2), (9, 1), (5, 1), (4, 1)])
def test_spatial_correlation_matches_jax(patch, dilation):
    rng = np.random.RandomState(patch * 10 + dilation)
    a = rng.randn(2, 9, 13, 16).astype(np.float32)
    b = rng.randn(2, 9, 13, 16).astype(np.float32)
    jax_corr = jax.jit(jcorr.spatial_correlation_sample, static_argnums=(2, 3))
    ref = np.asarray(jax_corr(jnp.asarray(a), jnp.asarray(b), patch, dilation))
    got = spatial_corr.spatial_correlation_sample(_t(a), _t(b), patch, dilation)
    assert got.shape == ref.shape == (2, 9, 13, patch * patch)
    assert _max_rel(got, ref) <= 1e-5
    # channel k = pi * patch + pj: y-major offsets
    pi, pj = 1, patch - 1
    dy, dx = (pi - (patch - 1) // 2) * dilation, (pj - (patch - 1) // 2) * dilation
    y, x = 8, 12 - dx
    assert abs(float(got[0, y, x, pi * patch + pj]) - float(a[0, y, x] @ b[0, y + dy, x + dx])) < 1e-4
    ref16 = jax_corr(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), patch, dilation)
    got16 = spatial_corr.spatial_correlation_sample(_t(a).bfloat16(), _t(b).bfloat16(), patch, dilation)
    assert got16.dtype == torch.bfloat16
    r = np.asarray(ref16.astype(jnp.float32))
    assert (np.abs(got16.float().numpy() - r) <= np.abs(r) * 2.0 ** -8 + 1e-6).all()


@pytest.mark.parametrize("hw,stride", [((50, 70), 32), ((64, 96), 32), ((436, 40), 32), ((20, 30), 8)])
def test_input_scaler_matches_jax(hw, stride):
    rng = np.random.RandomState(7)
    x = rng.rand(2, *hw, 3).astype(np.float32)
    js = jpadding.InputScaler(x.shape, stride=stride)
    ts = padding.InputScaler(x.shape, stride=stride, interpolation_align_corners=True)
    assert (ts.tgt_ht, ts.tgt_wd) == (js.tgt_ht, js.tgt_wd)
    filled = ts.fill(_t(x))
    assert _max_rel(filled, js.fill(jnp.asarray(x))) <= 2e-6
    f = rng.randn(2, ts.tgt_ht, ts.tgt_wd, 2).astype(np.float32)
    assert _max_rel(ts.unfill(_t(f), is_flow=True), js.unfill(jnp.asarray(f), is_flow=True)) <= 2e-6
    assert _max_rel(ts.unfill(_t(f[..., :1])), js.unfill(jnp.asarray(f[..., :1]))) <= 2e-6


@pytest.mark.parametrize("cin,cout,k,s,p,groups,bias", [
    (2, 2, 4, 2, 1, 2, False), (2, 2, 8, 4, 2, 2, False), (32, 32, 4, 2, 1, 1, True),
    (1, 1, 4, 2, 1, 1, False), (6, 4, 3, 2, 1, 2, True),
])
def test_deconv_matches_jax(cin, cout, k, s, p, groups, bias):
    rng = np.random.RandomState(cin + k)
    x = rng.randn(2, 5, 7, cin).astype(np.float32)
    mod = layers.deconv(cin, cout, k, s, p, bias=bias, groups=groups)
    layers.init_weights(mod, torch.Generator().manual_seed(1))
    if bias:
        with torch.no_grad():
            mod.bias.uniform_(-1, 1)
    tree = state_dict_to_flax({f"d.{n}": v for n, v in mod.state_dict().items()})["params"]["d"]
    jmod = jlayers.deconv(cout, k, s, p, name="d", use_bias=bias, groups=groups)
    ref = np.asarray(jmod.apply({"params": tree}, jnp.asarray(x)))
    got = mod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, (5 - 1) * s - 2 * p + k, (7 - 1) * s - 2 * p + k, cout)
    assert _max_rel(got.detach(), ref) <= 1e-6
    # the JAX init's kernel (kh, kw, out/g, in) lands on torch's (in, out/g, kh, kw)
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    sd = flax_to_state_dict({"params": {"d": init}})
    assert tuple(sd["d.weight"].shape) == tuple(mod.weight.shape)


@pytest.mark.parametrize("name", ["lfn3_standard", "lfn3_s_pseudoreg"])
def test_weight_round_trip(name):
    """The goldens' params load into the port strictly and come back
    unchanged, the grouped `up_flow` kernels (4x4x1x2, and the final 8x8x1x2
    of the standard variant) included."""
    tree = load_flax_checkpoint(os.path.join(GOLDENS, f"{name}_params.npz"))
    cfg = LFN3Config(use_s_version="_s_" in name, use_pseudo_regularization="pseudoreg" in name)
    model = LiteFlowNet3(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    back = state_dict_to_flax(model.state_dict())

    def flat(t, pre=()):
        for k, v in t.items():
            yield from flat(v, pre + (k,)) if isinstance(v, dict) else [(pre + (k,), v)]

    a, b = dict(flat(tree)), dict(flat(back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))
    up = "up_flow"
    assert a[("params", up, "kernel")].shape == ((8, 8, 1, 2) if "standard" in name else (4, 4, 1, 2))
    assert tuple(model.up_flow.weight.shape) == ((2, 1, 8, 8) if "standard" in name else (2, 1, 4, 4))


@pytest.mark.parametrize("kw", [dict(use_s_version=True), dict(use_pseudo_regularization=True)])
def test_state_dict_names_match_jax_params(kw):
    """Every flax parameter of the two variants without a golden has one
    port entry of its shape, with nothing left over on either side (shapes
    from `jax.eval_shape`; `test_weight_round_trip` covers the other two)."""
    images = jax.ShapeDtypeStruct((1, 2, 64, 96, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: JaxLiteFlowNet3(JaxLFN3Config(**kw)).init(
        jax.random.PRNGKey(0), x, training=True), images)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    sd = flax_to_state_dict(zeros)
    ref = LiteFlowNet3(LFN3Config(**kw), device="cpu").state_dict()
    assert sd.keys() == ref.keys()
    for k in sd:
        assert sd[k].shape == ref[k].shape, k
