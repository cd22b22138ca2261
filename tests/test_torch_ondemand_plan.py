"""K6's prepass (`corr_ondemand_df2_plan`) on the CPU: its plain version
against a direct numpy reckoning, and K6's gather over the plan (each fmap2
row summing only the queries the plan lists for it) against the plain fmap2
gradient.

The plan lists, for each level and fmap2 row y, the (query, row) pairs of
the queries whose taps cover row y, in ascending query order: pairs
starts[y] .. starts[y + 1]. Everything in the plan is an integer or an exact
fp32 value, so the comparisons are exact; the gather's sums take another
order than the plain version's einsums, so it is held to
max|d| <= 1e-5 * max|ref| (fp32).
"""

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
from torch_threads import one_torch_thread  # noqa: F401


def _coords(B, h, w, seed, spread):
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    c = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    c += rng.uniform(-spread, spread, c.shape).astype(np.float32)
    c[:, 0, :3] += 1.0e6  # far out of bounds
    c[:, 0, 3:5] -= 1.0e6
    c[:, 1, 0, 0] = w + 3.5  # straddling the right border
    c[:, 2, 1, 1] = -2.25  # straddling the top border
    return c.reshape(B, h * w, 2)


def _pyramid_shapes(h, w, levels=4):
    shapes = [(h, w)]
    for _ in range(levels - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    return shapes


def _numpy_plan(coords, shapes, r):
    """Per level: the (q, row) pairs in row, then query order, each with
    (t_x, t_y, fx, fy), and the rows' starts, by direct reckoning."""
    B, Q, _ = coords.shape
    NT = 2 * r + 2
    nbs = max(h + 1 for h, w in shapes if h > 0 and w > 0)
    out = []
    for lvl, (h, w) in enumerate(shapes):
        if h <= 0 or w <= 0:
            out.append(None)
            continue
        c = coords.astype(np.float32) * np.float32(2.0 ** -lvl)
        f = np.floor(c)
        frac = (c - f).astype(np.float32)
        tx = np.clip(f[..., 0], -(r + 2), w + r).astype(np.int64) - r
        ty = np.clip(f[..., 1], -(r + 2), h + r).astype(np.int64) - r
        per_b = []
        for b in range(B):
            pairs = [(y, q) for q in range(Q) if tx[b, q] + NT - 1 >= 0 and tx[b, q] < w
                     for y in range(max(ty[b, q], 0), min(ty[b, q] + NT, h))]
            pairs.sort()
            rows = np.array([y for y, _ in pairs], np.int64)
            qs = np.array([q for _, q in pairs], np.int64)
            starts = np.searchsorted(rows, np.arange(nbs), side="left")
            per_b.append((qs, tx[b, qs], ty[b, qs], frac[b, qs, 0], frac[b, qs, 1], starts))
        out.append(per_b)
    return out


CASES = [  # (h, w, radius, spread): 64x96 and 56x96 frames at 1/8
    (8, 12, 4, 6.0),
    (8, 12, 3, 2.0),
    (7, 12, 3, 40.0),  # levels 7x12 .. 0x1: an empty deepest level; coords over the level
]


@pytest.mark.parametrize("h,w,radius,spread", CASES)
def test_plan_matches_numpy(h, w, radius, spread):
    B = 2
    coords = _coords(B, h, w, seed=h + radius, spread=spread)
    shapes = _pyramid_shapes(h, w)
    entries, starts = co.corr_ondemand_df2_plan(torch.from_numpy(coords), shapes, radius)
    NT = 2 * radius + 2
    assert entries.shape == (B, 4, h * w * NT, 4) and entries.dtype == torch.int32
    assert starts.shape == (B, 4, co.plan_stride(shapes))
    assert co.LAUNCHES["corr_ondemand_df2_plan"] == 0  # a CPU tensor runs the plain version
    e, st = entries.numpy(), starts.numpy()
    for lvl, ref in enumerate(_numpy_plan(coords, shapes, radius)):
        if ref is None:
            assert (st[:, lvl] == 0).all()
            continue
        for b, (qs, tx, ty, fx, fy, ref_starts) in enumerate(ref):
            n = len(qs)
            np.testing.assert_array_equal(st[b, lvl], ref_starts)
            eb = e[b, lvl, :n]
            np.testing.assert_array_equal(eb[:, 0], qs)
            np.testing.assert_array_equal(eb[:, 1] >> 16, ty)
            np.testing.assert_array_equal(((eb[:, 1] & 0xFFFF) ^ 0x8000) - 0x8000, tx)
            np.testing.assert_array_equal(eb[:, 2].view(np.float32), fx)
            np.testing.assert_array_equal(eb[:, 3].view(np.float32), fy)
            assert (e[b, lvl, n:] == 0).all()


def _gather_df2(f1, g, entries, starts, shapes, radius):
    """K6's gather in numpy: for each row y, the plan's pairs of row y, each
    adding drows(row y) * f1[q] to its in-bounds taps, in pair order."""
    B, Q, C = f1.shape
    K, NT = 2 * radius + 1, 2 * radius + 2
    gs = g.astype(np.float64) / np.sqrt(C)
    out = []
    for lvl, (h, w) in enumerate(shapes):
        d = np.zeros((B, h, w, C))
        for b in range(B):
            for y in range(h):
                for en in entries[b, lvl, starts[b, lvl, y]:starts[b, lvl, y + 1]]:
                    q, tx, ty = en[0], ((en[1] & 0xFFFF) ^ 0x8000) - 0x8000, en[1] >> 16
                    fx, fy = en[2:4].view(np.float32).astype(np.float64)
                    j = y - ty
                    gl = gs[b, q, lvl * K * K:(lvl + 1) * K * K].reshape(K, K)  # [a, c]
                    gy = np.array([(1 - fy) * (gl[a, j] if j < K else 0.0)
                                   + fy * (gl[a, j - 1] if j >= 1 else 0.0) for a in range(K)])
                    for i in range(NT):
                        x = tx + i
                        if 0 <= x < w:
                            di = (1 - fx) * (gy[i] if i < K else 0.0) + fx * (gy[i - 1] if i else 0.0)
                            d[b, y, x] += di * f1[b, q]
        out.append(d)
    return out


@pytest.mark.parametrize("h,w,radius,spread", CASES[1:])
def test_gather_over_plan_matches_plain_df2(h, w, radius, spread):
    B, C = 2, 8
    rng = np.random.RandomState(5)
    coords = _coords(B, h, w, seed=h + radius, spread=spread)
    shapes = _pyramid_shapes(h, w)
    f1 = rng.randn(B, h * w, C).astype(np.float32)
    g = rng.randn(B, h * w, len(shapes) * (2 * radius + 1) ** 2).astype(np.float32)
    tc = torch.from_numpy(coords)
    ref = co.corr_ondemand_bwd_df2_plain(torch.from_numpy(f1), tc, torch.from_numpy(g), shapes,
                                         radius)
    entries, starts = co.corr_ondemand_df2_plan(tc, shapes, radius)
    got = _gather_df2(f1, g, entries.numpy(), starts.numpy(), shapes, radius)
    for a, b in zip(got, ref):
        assert a.shape == tuple(b.shape)
        if b.numel():
            np.testing.assert_allclose(a, b.double().numpy(), rtol=0,
                                       atol=1e-5 * float(b.abs().max()))
