"""The staged-box arithmetic of the lookup kernels K1, K2 and K8, on the CPU.

The CUDA kernels (`kernels/csrc/corr_lookup.cu`) stage, per query and level,
the box of pixels that the window's taps can reach and form the window from
it. Two facts make that exact, and this file holds both against
`ops/corr.py::sample_corr_window`, the kernels' plain version:

  - per axis, the taps of centre c lie in floor(c) - r .. floor(c) + r + 2:
    fl(c + (a - r)) may round up across an integer, so floor(px) is
    floor(c) + (a - r) or one more, never less. The box is K+2 pixels a
    side, not K+1;
  - a window formed from the box, each tap addressed by the tap index that
    `sample_corr_window` computes, out-of-bounds taps reading a zero row or
    column beside the box and every cell outside the level left as garbage
    (NaN here), equals `sample_corr_window` bit for bit.
"""

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.ops.corr import sample_corr_window
from torch_threads import one_torch_thread  # noqa: F401


def hard_centres(rng, n, lo, hi):
    """n fp32 centres of one axis: uniform in [lo, hi), within 1e-6 of
    integers on both sides, the floats just below and just above integers,
    integers, negative ones, and magnitudes up to 1e6."""
    c = rng.uniform(lo, hi, n).astype(np.float32)
    m = np.round(c).astype(np.float32)
    k = np.arange(n) % 7
    c[k == 1] = (m + rng.uniform(-1e-6, 1e-6, n).astype(np.float32))[k == 1]
    c[k == 2] = np.nextafter(m, np.float32(-np.inf))[k == 2]
    c[k == 3] = np.nextafter(m, np.float32(np.inf))[k == 3]
    c[k == 4] = m[k == 4]
    c[k == 5] = -np.abs(c[k == 5])
    far = rng.uniform(1.0, 1.0e6, n).astype(np.float32) * rng.choice([-1, 1], n)
    c[np.arange(n) % 13 == 6] = far[np.arange(n) % 13 == 6]
    return c


def centres_for(rng, n, H, W):
    """(cx, cy) [1, n]: hard centres around an H x W level, a tenth of them on
    its border rows and columns."""
    cx = hard_centres(rng, n, -6.0, W + 5.0)
    cy = hard_centres(rng, n, -6.0, H + 5.0)
    border = np.arange(n) % 10 == 8
    cx[border] = (W - 1 + rng.choice([-4.0, -0.5, 0.0, 0.5, 4.0], n))[border]
    cy[border] = rng.choice([-4.0, -0.5, 0.0, 0.5, H - 1.0], n)[border]
    return torch.from_numpy(cx[None].astype(np.float32)), torch.from_numpy(cy[None].astype(np.float32))


def tap_index(c, radius):
    """[..., K]: floor(fl(c + (a - r))), `sample_corr_window`'s tap x0 (or y0)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32)
    return torch.floor(c[..., None] + d)


@pytest.mark.parametrize("radius", [3, 4])
def test_taps_lie_in_the_k_plus_2_box(radius):
    """Every tap (x0 and x0 + 1) of every window column lies in floor(c) - r ..
    floor(c) + r + 2; some centres need the last of those K+2 pixels."""
    rng = np.random.RandomState(radius)
    c = torch.from_numpy(np.concatenate([hard_centres(rng, 200_000, -100.0, 300.0),
                                         hard_centres(rng, 50_000, -2.0e5, 2.0e5)]))
    x0 = tap_index(c, radius)
    lo = torch.floor(c)[..., None] - radius
    assert bool((x0 >= lo).all())
    assert bool((x0 + 1 <= lo + 2 * radius + 2).all())
    shift = x0 - lo - torch.arange(2 * radius + 1, dtype=torch.float32)
    assert set(torch.unique(shift).tolist()) == {0.0, 1.0}


def _outside_box_is_inf(H, W, cx, cy, width, radius):
    """[1, n, H, W] fp32: finite values in each query's box of `width` pixels
    a side from (floor(c) - r), +inf elsewhere (inf * 0 is NaN, so a tap
    outside the box shows even under a weight of 0)."""
    n = cx.shape[1]
    rng = np.random.RandomState(H * 100 + W + width)
    v = torch.from_numpy(rng.randn(1, n, H, W).astype(np.float32))
    x = torch.arange(W, dtype=torch.float32)
    y = torch.arange(H, dtype=torch.float32)
    bx = (torch.floor(cx) - radius)[..., None]
    by = (torch.floor(cy) - radius)[..., None]
    in_x = (x >= bx) & (x < bx + width)
    in_y = (y >= by) & (y < by + width)
    inside = in_y[..., :, None] & in_x[..., None, :]
    return torch.where(inside, v, torch.full_like(v, float("inf")))


@pytest.mark.parametrize("radius", [3, 4])
def test_plain_window_reads_only_the_box(radius):
    """sample_corr_window reads nothing outside each query's (K+2)^2 box
    (its output stays finite when every other pixel is +inf), and a (K+1)^2
    box is not enough."""
    H, W, K = 23, 31, 2 * radius + 1
    rng = np.random.RandomState(10 + radius)
    # centres with in-bounds taps, many just below an integer of the lower
    # binade edge, where c + r rounds up across the next integer
    m = rng.randint(1, 18, 4000).astype(np.float32)
    cx = np.nextafter(m, np.float32(-np.inf)).astype(np.float32)
    cy = rng.uniform(-2.0, H + 1.0, 4000).astype(np.float32)
    cx, cy = torch.from_numpy(cx[None]), torch.from_numpy(cy[None])
    wide = sample_corr_window(_outside_box_is_inf(H, W, cx, cy, K + 2, radius), cx, cy, radius)
    assert bool(torch.isfinite(wide).all())
    narrow = sample_corr_window(_outside_box_is_inf(H, W, cx, cy, K + 1, radius), cx, cy, radius)
    assert not bool(torch.isfinite(narrow).all())


def box_window(corr_l, cx, cy, radius):
    """The window of each query as the kernels form it: stage the (K+2)^2 box
    from (floor(c) - r) (its corner clipped in float before the int cast),
    cells outside the level left as garbage (NaN); a zero column and a zero
    row beside it; each tap addressed by its tap index relative to the box, an
    out-of-bounds tap sent to the zero column or row; the four products and
    their sum in sample_corr_window's order. [B, Q, H, W] -> [B, Q, K^2] fp32."""
    B, Q, H, W = corr_l.shape
    K = 2 * radius + 1
    if H == 0 or W == 0:
        return torch.zeros(B, Q, K * K)
    side, pitch = K + 2, K + 3
    zero_col, zero_row = side, side * pitch
    lo = -float(K + 2)
    bx = (torch.floor(cx) - radius).clamp(lo, W).long()  # [B, Q]
    by = (torch.floor(cy) - radius).clamp(lo, H).long()
    # 2. stage: cell (i, j) of the box is pixel (by + i, bx + j) inside the level
    i = torch.arange(side)
    ys = by[..., None, None] + i[:, None]
    xs = bx[..., None, None] + i[None, :]
    inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    flat = corr_l.reshape(B, Q, H * W).float()
    idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).reshape(B, Q, side * side)
    staged = torch.gather(flat, 2, idx).reshape(B, Q, side, side)
    box = torch.full((B, Q, pitch, pitch), float("nan"))
    box[..., :side, :side] = torch.where(inside, staged, torch.full_like(staged, float("nan")))
    box[..., :, zero_col] = 0.0
    box[..., side, :] = 0.0
    box = box.reshape(B, Q, pitch * pitch)

    # 1. the taps of each window column (x) and row (y), sample_corr_window's arithmetic
    def taps(c, n, first, step, zero):
        p = c[..., None] + torch.arange(-radius, radius + 1, dtype=torch.float32)
        p0 = torch.floor(p)
        w = p - p0
        pi = p0.clamp(-2, n).long()
        t0 = torch.where((pi >= 0) & (pi <= n - 1), (pi - first[..., None]) * step, zero)
        t1 = torch.where((pi + 1 >= 0) & (pi + 1 <= n - 1), (pi + 1 - first[..., None]) * step, zero)
        return t0, t1, w, 1 - w

    c0, c1, wx, omx = taps(cx, W, bx, 1, zero_col)  # [B, Q, K] over window columns a
    r0, r1, wy, omy = taps(cy, H, by, pitch, zero_row)  # over window rows b
    # 3. outputs k = a*K + b
    c0, c1, wx, omx = (t[..., :, None] for t in (c0, c1, wx, omx))
    r0, r1, wy, omy = (t[..., None, :] for t in (r0, r1, wy, omy))

    def at(cell):
        return torch.gather(box, 2, cell.reshape(B, Q, K * K)).reshape(B, Q, K, K)

    t00 = at(r0 + c0) * omy * omx
    t01 = at(r0 + c1) * omy * wx
    t10 = at(r1 + c0) * wy * omx
    t11 = at(r1 + c1) * wy * wx
    return (t00 + t01 + t10 + t11).reshape(B, Q, K * K)


# the serving levels (1024x440 input), the training levels (368x496) and a
# level emptied by floor-mode pooling
LEVELS = [(55, 128), (27, 64), (13, 32), (6, 16), (46, 62), (23, 31), (11, 15), (5, 7), (0, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", LEVELS)
def test_box_window_equals_plain(hw, radius, dtype):
    H, W = hw
    B, n = (1, 300) if H * W > 2000 else (2, 400)
    rng = np.random.RandomState(H * 1000 + W + radius)
    pairs = [centres_for(rng, n, H, W) for _ in range(B)]
    cx = torch.cat([p[0] for p in pairs])
    cy = torch.cat([p[1] for p in pairs])
    corr = torch.from_numpy(rng.randn(B, n, H, W).astype(np.float32)).to(dtype)
    got = box_window(corr, cx, cy, radius)
    ref = sample_corr_window(corr, cx, cy, radius)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.equal(got, ref)
    assert bool(torch.isfinite(got).all())
