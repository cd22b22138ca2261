"""Correlation pyramid and windowed lookup: port against the JAX package.

The port's lookup on CPU tensors is the kernels' plain version (the CUDA
kernels themselves are held against it on the card by chip_smoke.py). It is
compared with the JAX XLA lookup and with the Pallas kernels run in interpret
mode (per level, and with the coarse levels fused), at 1e-5 abs: both sides
compute the same fp32 bilinear sums, so only summation order can differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_optical_flow_tpu.kernels.corr_lookup import corr_pyramid_lookup_pallas
from raft_optical_flow_tpu.ops import corr as jcorr
from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.ops import corr as tcorr
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(seed=0, B=2, H=12, W=16, C=32, max_disp=4.0):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, H, W, C).astype(np.float32)
    f2 = rng.randn(B, H, W, C).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-max_disp, max_disp, coords.shape).astype(np.float32)
    return f1, f2, coords


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _pyramids(f1, f2, levels=4):
    jp = jcorr.build_corr_pyramid_from_fmaps(jnp.asarray(f1), jnp.asarray(f2), levels)
    tp = tcorr.build_corr_pyramid_from_fmaps(_t(f1), _t(f2), levels)
    return jp, tp


@pytest.mark.parametrize("shape", [(12, 16), (11, 13), (6, 8)])
def test_pyramid_from_fmaps_matches_jax(shape):
    f1, f2, _ = _inputs(seed=1, H=shape[0], W=shape[1])
    jp, tp = _pyramids(f1, f2)
    assert [tuple(c.shape) for c in tp] == [tuple(c.shape) for c in jp]
    for a, b in zip(jp, tp):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(a).max(initial=0)))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_matches_jax_and_pallas_interpret(radius, fuse):
    f1, f2, coords = _inputs(seed=7)
    jp, tp = _pyramids(f1, f2)
    ref = np.asarray(jcorr.corr_pyramid_lookup(jp, jnp.asarray(coords), radius))
    pallas = np.asarray(
        corr_pyramid_lookup_pallas(jp, jnp.asarray(coords), radius, interpret=True, fuse_coarse=fuse)
    )
    plain = tcorr.corr_pyramid_lookup(tp, _t(coords), radius).numpy()
    wrapped = ck.corr_pyramid_lookup_cuda(tp, _t(coords), radius, fuse_coarse=fuse).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain, pallas, rtol=0, atol=1e-5)


def test_lookup_far_out_of_bounds_is_zero():
    f1, f2, coords = _inputs(seed=2)
    _, tp = _pyramids(f1, f2)
    for shift in (100.0, -100.0, 3.0e9, -3.0e9):
        out = ck.corr_pyramid_lookup_cuda(tp, _t(coords + shift), 4, fuse_coarse=True)
        assert torch.all(out == 0.0)


@pytest.mark.parametrize("fuse", [False, True])
def test_lookup_trailing_empty_level(fuse):
    f1, f2, coords = _inputs(seed=8, H=6, W=8)
    jp, tp = _pyramids(f1, f2)
    assert tp[-1].shape[2] == 0
    ref = np.asarray(
        corr_pyramid_lookup_pallas(jp, jnp.asarray(coords), 3, interpret=True, fuse_coarse=fuse)
    )
    out = ck.corr_pyramid_lookup_cuda(tp, _t(coords), 3, fuse_coarse=fuse).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.all(out[..., 3 * 49 :] == 0.0)


def test_lookup_empty_pyramid_level():
    rng = np.random.RandomState(7)
    B, h, w, C, r = 1, 6, 12, 16, 3
    f1 = rng.randn(B, h, w, C).astype(np.float32)
    f2 = rng.randn(B, h, w, C).astype(np.float32)
    jp, tp = _pyramids(f1, f2)
    assert tp[-1].shape[2] == 0
    coords = rng.uniform(0, [w - 1, h - 1], (B, h, w, 2)).astype(np.float32)
    ref = np.asarray(corr_pyramid_lookup_pallas(jp, jnp.asarray(coords), r, interpret=True))
    out = ck.corr_pyramid_lookup_cuda(tp, _t(coords), r).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.all(out[..., 3 * 49 :] == 0.0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_bf16_volume_lookup_matches_jax(out_dtype):
    """bf16 volume: fp32 weights and sums, one rounding to the output dtype."""
    f1, f2, coords = _inputs(seed=11)
    jp, tp = _pyramids(f1, f2)
    jp = tuple(c.astype(jnp.bfloat16) for c in jp)
    tp = tuple(c.bfloat16() for c in tp)
    ref = np.asarray(jcorr.corr_pyramid_lookup(jp, jnp.asarray(coords), 4), np.float32)
    out = ck.corr_pyramid_lookup_cuda(tp, _t(coords), 4, out_dtype, fuse_coarse=True)
    assert out.dtype == out_dtype
    tol = 1e-5 if out_dtype == torch.float32 else 8e-3 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)


def test_level_wrappers_match_plain_sampler():
    f1, f2, coords = _inputs(seed=12, B=1)
    _, tp = _pyramids(f1, f2)
    flat = _t(coords).reshape(1, -1, 2)
    k1 = ck.corr_lookup_level(tp[1], (flat / 2).contiguous(), 3)
    ref = tcorr.sample_corr_window(tp[1], flat[..., 0] / 2, flat[..., 1] / 2, 3)
    torch.testing.assert_close(k1, ref, rtol=0, atol=0)
    k2 = ck.corr_lookup_coarse_fused(tp[1:], flat, 3)
    assert k2.shape == (1, flat.shape[1], 3 * 49)
    torch.testing.assert_close(k2[..., :49], ref, rtol=0, atol=0)


def test_wrappers_refuse_bad_inputs():
    f1, f2, coords = _inputs(seed=13, B=1)
    _, tp = _pyramids(f1, f2)
    flat = _t(coords).reshape(1, -1, 2)
    with pytest.raises(TypeError):
        ck.corr_lookup_level(tp[0].double(), flat, 3)
    with pytest.raises(ValueError):
        ck.corr_lookup_level(tp[0], flat[:, :-1], 3)
    with pytest.raises(ValueError):
        ck.corr_lookup_level(tp[0], flat.half().float()[..., :1], 3)
    with pytest.raises(TypeError):
        ck.corr_lookup_level(tp[0], flat, 3, out_dtype=torch.float16)
    with pytest.raises(TypeError):
        ck.corr_lookup_coarse_fused([tp[1], tp[2].bfloat16()], flat, 3)
    with pytest.raises(ValueError):
        ck.corr_lookup_coarse_fused([], flat, 3)


def test_plain_runs_do_not_count_launches():
    f1, f2, coords = _inputs(seed=14, B=1)
    _, tp = _pyramids(f1, f2)
    ck.reset_launches()
    ck.corr_pyramid_lookup_cuda(tp, _t(coords), 3, fuse_coarse=True)
    assert ck.LAUNCHES == {"corr_lookup_level": 0, "corr_lookup_coarse_fused": 0,
                           "corr_lookup_level_bwd": 0, "corr_lookup_all_levels": 0}


@pytest.mark.parametrize("shape", [(7, 9), (8, 8), (1, 5)])
def test_avg_pool_floor_mode_matches_jax(shape):
    x = np.random.RandomState(15).randn(2, 3, *shape).astype(np.float32)
    ref = np.asarray(jcorr.avg_pool2x2(jnp.asarray(x)))
    out = tcorr.avg_pool2x2(_t(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
