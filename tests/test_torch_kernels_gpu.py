"""CUDA kernels of the port against their plain versions, on the card.

Needs a CUDA card: every test is marked `gpu` and skips without one (decided
inside the fixture, so every worker collects the same tests). The file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

K1 and K2 repeat their plain version's fp32 operations in the same order
without fused multiply-adds, so the two agree exactly. K3 (the volume
gradient) sums its at most four taps in another order than its plain
version's einsums: max_rel = max|d| / max|ref| within 2e-5 (fp32 volume) and
3e-2 (bf16), the repo's lookup-VJP gates. K4-K6 (on-demand correlation) sum
their C-long dot products in another order than their plain version's
einsums: fp32 outputs within max_rel 2e-5; K4's bf16 windows within one
bf16 rounding step of the plain fp32 value (plus 2e-5 * max|ref| for sums
that cancel); K6 gives the same bits on every run, and its prepass (integers
and exact fp32 values) equals its plain version. K4's bf16 tiles of 64
queries and K6's row runs are also held on the inputs that could break them:
a ragged last tile, tiles across the level's border, one far query in a
tile, coords spread over the whole level (K4's per-query route) and a
smooth field. K7 (one SepConvGRU pass)
sums its 5*(D+X)-long gate products in another order than its plain
version's matmuls: fp32 within max_rel 1e-5; bf16 within one bf16 rounding
step of the plain value, plus what one flipped rounding of r*h (a bf16 step of
|rh| < 1, 2^-8) carries through the largest q-gate weight, plus 2e-5 *
max|ref| for the sums' order; its fp32 route keeps the sum order of the
kernel it replaced and is held to that kernel's outputs bit for bit (a
digest). K8 (all levels) repeats K1's operations: exact.
K1, K2 and K8 are also held bit for bit on hard cases: the training level
shapes and rows shorter than a window, centres within 1e-6 of integers and
just below them, far and border rows, 1% +inf volume values (so that a wrong
pixel under a weight of 0 shows as a NaN), and B*Q of 1, 7 and 1001; and at
radii that take each other launch route (K from the radius, a block past 48 KB
of shared memory, the per-output route for a box too wide for a block).
"""

import os

import numpy as np
import pytest
import torch

from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
from raft_optical_flow_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps

pytestmark = pytest.mark.gpu
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(device, h, w, dtype, seed, B=2, C=64):
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(device)
    f2 = torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(device)
    gy, gx = np.mgrid[0:h, 0:w]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-6, 6, coords.shape).astype(np.float32)
    coords[:, 0] += 1.0e7  # a row of queries far out of bounds
    return build_corr_pyramid_from_fmaps(f1, f2, 4, dtype), torch.from_numpy(coords).to(device)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
def test_kernels_match_plain(cuda, radius, vol_dtype, out_dtype):
    pyr, coords = _case(cuda, 15, 22, vol_dtype, seed=radius)
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).contiguous()
    for lvl, c in enumerate(pyr):
        cl = (flat / 2**lvl).contiguous()
        got = ck.corr_lookup_level(c, cl, radius, out_dtype)
        torch.testing.assert_close(got, ck.corr_lookup_level_plain(c, cl, radius, out_dtype),
                                   rtol=0, atol=0)
    got = ck.corr_lookup_coarse_fused(pyr[1:], flat, radius, out_dtype)
    torch.testing.assert_close(
        got, ck.corr_lookup_coarse_fused_plain(pyr[1:], flat, radius, out_dtype), rtol=0, atol=0)


@pytest.mark.parametrize("fuse", [False, True])
def test_pyramid_lookup_with_empty_level(cuda, fuse):
    pyr, coords = _case(cuda, 7, 16, torch.float32, seed=5)
    assert pyr[-1].shape[2] == 0
    from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup

    ck.reset_launches()
    got = ck.corr_pyramid_lookup_cuda(pyr, coords, 3, torch.float32, fuse)
    torch.testing.assert_close(got, corr_pyramid_lookup(pyr, coords, 3), rtol=0, atol=0)
    expect = ({"corr_lookup_level": 1, "corr_lookup_coarse_fused": 1} if fuse
              else {"corr_lookup_level": 3, "corr_lookup_coarse_fused": 0})
    expect.update(corr_lookup_level_bwd=0, corr_lookup_all_levels=0)
    assert ck.LAUNCHES == expect


def test_raft_small_golden_on_card(cuda):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    model = RAFT(RAFTConfig(small=True))
    model.load_state_dict(load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz")))
    i1 = torch.from_numpy(g["image1"].astype(np.float32))[None].to(cuda)
    i2 = torch.from_numpy(g["image2"].astype(np.float32))[None].to(cuda)
    _, flow_up = model(i1, i2, iters=int(g["iters"]))
    epe = np.linalg.norm(flow_up.cpu().numpy() - g["flow_up"], axis=-1)
    assert epe.mean() < 1e-3 and epe.max() < 5e-3


def _max_rel(got, ref):
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_bwd_matches_plain(cuda, radius, vol_dtype, g_dtype):
    pyr, coords = _case(cuda, 15, 22, vol_dtype, seed=10 + radius)
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(radius)
    K2 = (2 * radius + 1) ** 2
    g = torch.randn(B, h * w, K2, device=cuda, generator=gen).to(g_dtype)
    ck.reset_launches()
    for lvl, c in enumerate(pyr):
        cl = (flat / 2**lvl).contiguous()
        Hl, Wl = c.shape[2:]
        got = ck.corr_lookup_level_bwd(cl, g, Hl, Wl, radius, vol_dtype)
        ref = ck.corr_lookup_level_bwd_plain(cl, g, Hl, Wl, radius, torch.float32)
        assert got.dtype == vol_dtype and got.shape == (B, h * w, Hl, Wl)
        tol = 2e-5 if vol_dtype == torch.float32 else 3e-2
        assert _max_rel(got, ref) <= tol, (lvl, _max_rel(got, ref))
        assert torch.all(got[:, :w] == 0)  # the far out-of-bounds row
    assert ck.LAUNCHES["corr_lookup_level_bwd"] == len(pyr)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(46, 62), (23, 31), (11, 15), (5, 7), (1, 5), (2, 3), (1, 1)])
def test_lookup_bwd_level_shapes(cuda, hw, vol_dtype, g_dtype):
    """K3 at the four levels of the 368x496 training shape (Q = 46*62 queries,
    radius 4) and at rows shorter than one 16-byte store (8 bf16 or 4 fp32
    elements: the stores straddle rows and queries), coords around and inside
    the level, integral ones among them, and rows of queries far outside it
    on either side (their rows all zero)."""
    Hl, Wl = hw
    B, Q, radius = 1, 46 * 62, 4
    rng = np.random.RandomState(Hl * 100 + Wl)
    coords = np.stack([rng.uniform(-6, Wl + 5, (B, Q)), rng.uniform(-6, Hl + 5, (B, Q))], -1)
    coords[:, ::7] = np.round(coords[:, ::7])
    coords[:, :40] = 1.0e7
    coords[:, 40:80] = -1.0e7
    coords = torch.from_numpy(coords.astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.randn(B, Q, (2 * radius + 1) ** 2).astype(np.float32))
    g = g.to(cuda, g_dtype)
    ck.reset_launches()
    got = ck.corr_lookup_level_bwd(coords, g, Hl, Wl, radius, vol_dtype)
    ref = ck.corr_lookup_level_bwd_plain(coords, g, Hl, Wl, radius, torch.float32)
    assert ck.LAUNCHES["corr_lookup_level_bwd"] == 1
    assert got.dtype == vol_dtype and got.shape == (B, Q, Hl, Wl)
    tol = 2e-5 if vol_dtype == torch.float32 else 3e-2
    assert _max_rel(got, ref) <= tol
    assert torch.all(got[:, :80] == 0)


def test_lookup_function_backward_on_card(cuda):
    pyr, coords = _case(cuda, 9, 12, torch.bfloat16, seed=3)
    tp = [c.detach().requires_grad_() for c in pyr]
    ck.reset_launches()
    out = ck.corr_pyramid_lookup_cuda(tp, coords, 4, torch.bfloat16)
    out.float().square().sum().backward()
    assert ck.LAUNCHES == {"corr_lookup_level": 4, "corr_lookup_coarse_fused": 0,
                           "corr_lookup_level_bwd": 4, "corr_lookup_all_levels": 0}
    assert all(p.grad.dtype == torch.bfloat16 and torch.isfinite(p.grad.float()).all() for p in tp)


def test_lookup_bwd_empty_level_launches_nothing(cuda):
    coords = torch.zeros(1, 5, 2, device=cuda)
    g = torch.ones(1, 5, 49, device=cuda)
    ck.reset_launches()
    assert ck.corr_lookup_level_bwd(coords, g, 0, 3, 3).shape == (1, 5, 0, 3)
    assert ck.LAUNCHES["corr_lookup_level_bwd"] == 0


def _hard_centres(rng, n, Hl, Wl, scale=1):
    """n level-0 centres (x, y) for a level of Hl x Wl at 1/scale: around and
    inside it, within 1e-6 of integers on both sides, the float just below an
    integer (where c + (a - r) rounds up across the next integer), rows far
    out of bounds on both sides, and the border rows."""
    c = np.stack([rng.uniform(-6, Wl + 5, n), rng.uniform(-6, Hl + 5, n)], -1) * scale
    c = c.astype(np.float32)
    m = np.round(c / scale) * scale
    k = np.arange(n) % 5
    c[k == 1] = (m + rng.uniform(-1e-6, 1e-6, (n, 2)) * scale)[k == 1]
    c[k == 2] = np.nextafter(m.astype(np.float32), np.float32(-np.inf))[k == 2]
    c[k == 3] = m[k == 3]
    edge = np.arange(n) % 11 == 4
    c[edge, 0] = (Wl - 1 + rng.choice([-4.5, -0.5, 0.0, 0.5, 3.5, 4.5], edge.sum())) * scale
    c[edge, 1] = (rng.choice([-4.5, -0.5, 0.0, 0.5, 3.5], edge.sum())) * scale
    if n > 2:
        c[1] = 1.0e6
        c[2] = -1.0e6
    return c.astype(np.float32)


def _volume(rng, B, Q, Hl, Wl, dtype, device):
    """Seeded normal values with 1% +inf: a tap of weight 0 on an inf reads
    NaN, so a kernel that reads the wrong pixel there shows."""
    v = rng.randn(B, Q, Hl, Wl).astype(np.float32)
    v[rng.rand(*v.shape) < 0.01] = np.inf
    return torch.from_numpy(v).to(device, dtype)


def _assert_same(got, ref):
    """The same bits: NaN positions and the signs of zeros included."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    as_int = torch.int32 if got.element_size() == 4 else torch.int16
    assert torch.equal(got.view(as_int), ref.view(as_int))


LEVEL_SHAPES = [(46, 62), (23, 31), (11, 15), (5, 7), (1, 5), (2, 3), (1, 1)]
DTYPE_PAIRS = [(v, o) for v in (torch.float32, torch.bfloat16) for o in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtypes", DTYPE_PAIRS)
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("hw", LEVEL_SHAPES)
def test_lookup_level_hard_cases(cuda, hw, radius, dtypes):
    """K1 bit for bit with its plain version at the training level shapes and
    rows shorter than a window, on hard centres, for B*Q of 1, 7 and 1001 (a
    block of 16 windows with a tail)."""
    vol_dtype, out_dtype = dtypes
    Hl, Wl = hw
    rng = np.random.RandomState(Hl * 1000 + Wl * 10 + radius)
    for B, Q in ((1, 1), (1, 7), (7, 143)):
        corr = _volume(rng, B, Q, Hl, Wl, vol_dtype, cuda)
        coords = torch.from_numpy(_hard_centres(rng, B * Q, Hl, Wl).reshape(B, Q, 2)).to(cuda)
        ck.reset_launches()
        got = ck.corr_lookup_level(corr, coords, radius, out_dtype)
        assert ck.LAUNCHES["corr_lookup_level"] == 1
        _assert_same(got, ck.corr_lookup_level_plain(corr, coords, radius, out_dtype))


# level shapes of a pyramid, level 0 first: the 368x496 training shape's and
# one of rows shorter than a window whose deepest levels are empty
PYRAMIDS = {"train": [(46, 62), (23, 31), (11, 15), (5, 7)],
            "tiny": [(2, 5), (1, 2), (0, 1), (0, 0)]}


@pytest.mark.parametrize("dtypes", DTYPE_PAIRS)
@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("pyramid", sorted(PYRAMIDS))
def test_lookup_coarse_and_all_levels_hard_cases(cuda, pyramid, radius, dtypes):
    """K2 (levels 1..3, out_dtype) and K8 (levels 0..3, fp32 out) bit for bit
    with their plain versions on hard centres at every level (level-0 centres
    near multiples of 8 are near integers at level 3), for B*Q of 1, 7, 1001."""
    vol_dtype, out_dtype = dtypes
    shapes = PYRAMIDS[pyramid]
    rng = np.random.RandomState(sum(h * 100 + w for h, w in shapes) * 10 + radius)
    for B, Q in ((1, 1), (1, 7), (7, 143)):
        levels = [_volume(rng, B, Q, Hl, Wl, vol_dtype, cuda) for Hl, Wl in shapes]
        scale = 2 ** int(rng.randint(0, 4))
        c = _hard_centres(rng, B * Q, *shapes[0], scale=1) if scale == 1 else \
            _hard_centres(rng, B * Q, max(shapes[0][0] // scale, 1), max(shapes[0][1] // scale, 1),
                          scale=scale)
        coords = torch.from_numpy(c.reshape(B, Q, 2)).to(cuda)
        ck.reset_launches()
        got = ck.corr_lookup_coarse_fused(levels[1:], coords, radius, out_dtype)
        got8 = ck.corr_pyramid_lookup_cuda_fused(levels, coords.reshape(B, 1, Q, 2), radius)
        assert ck.LAUNCHES["corr_lookup_coarse_fused"] == 1
        assert ck.LAUNCHES["corr_lookup_all_levels"] == 1
        _assert_same(got, ck.corr_lookup_coarse_fused_plain(levels[1:], coords, radius, out_dtype))
        _assert_same(got8, ck.corr_pyramid_lookup_fused_plain(levels, coords.reshape(B, 1, Q, 2),
                                                              radius))


@pytest.mark.parametrize("dtypes", DTYPE_PAIRS)
@pytest.mark.parametrize("radius", [2, 5, 50, 120])
def test_lookup_other_radii(cuda, radius, dtypes):
    """K1, K2 and K8 bit for bit with their plain versions at radii with no
    template constant for K, on hard centres at the training level shapes:
    r = 2 and 5 (several windows a block), r = 50 (one window a block, past
    48 KB of shared memory, so the launch opts in to more) and r = 120 (a box
    past a block's shared memory: the per-output route)."""
    vol_dtype, out_dtype = dtypes
    shapes = PYRAMIDS["train"]
    rng = np.random.RandomState(radius * 10 + DTYPE_PAIRS.index(dtypes))
    for B, Q in ((1, 7),) if radius > 5 else ((1, 7), (7, 143)):
        levels = [_volume(rng, B, Q, Hl, Wl, vol_dtype, cuda) for Hl, Wl in shapes]
        coords = torch.from_numpy(_hard_centres(rng, B * Q, *shapes[0]).reshape(B, Q, 2)).to(cuda)
        ck.reset_launches()
        got1 = ck.corr_lookup_level(levels[0], coords, radius, out_dtype)
        got2 = ck.corr_lookup_coarse_fused(levels[1:], coords, radius, out_dtype)
        got8 = ck.corr_pyramid_lookup_cuda_fused(levels, coords.reshape(B, 1, Q, 2), radius)
        assert all(ck.LAUNCHES[k] == 1 for k in (
            "corr_lookup_level", "corr_lookup_coarse_fused", "corr_lookup_all_levels"))
        _assert_same(got1, ck.corr_lookup_level_plain(levels[0], coords, radius, out_dtype))
        _assert_same(got2, ck.corr_lookup_coarse_fused_plain(levels[1:], coords, radius, out_dtype))
        _assert_same(got8, ck.corr_pyramid_lookup_fused_plain(levels, coords.reshape(B, 1, Q, 2),
                                                              radius))


def _ondemand_case(device, h, w, C, dtype, seed, B=2, far=True):
    from raft_optical_flow_tpu_torch.ops.corr import avg_pool2x2

    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy(rng.randn(B, h * w, C).astype(np.float32)).to(device)
    levels = [torch.from_numpy(rng.randn(B, h, w, C).astype(np.float32)).to(device)]
    for _ in range(3):
        levels.append(avg_pool2x2(levels[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    gy, gx = np.mgrid[0:h, 0:w]
    coords = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    coords += rng.uniform(-6, 6, coords.shape).astype(np.float32)
    if far:
        coords[:, 0] += 1.0e7  # a row of queries far out of bounds
    return (f1.to(dtype).contiguous(), [f.to(dtype).contiguous() for f in levels],
            torch.from_numpy(coords).reshape(B, h * w, 2).to(device))


def _bf16_step(ref):
    """One bf16 rounding step (ulp) at each value of ref."""
    _, e = torch.frexp(ref)
    return torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), e - 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,C,hw", [(3, 128, (15, 22)), (4, 256, (15, 22)), (3, 128, (7, 16))])
def test_ondemand_kernels_match_plain(cuda, radius, C, hw, dtype):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    f1, levels, coords = _ondemand_case(cuda, *hw, C, dtype, seed=radius + C)
    B, Q, _ = coords.shape
    co.reset_launches()
    out = co.corr_ondemand_fwd(f1, levels, coords, radius, dtype)
    ref = co.corr_ondemand_fwd_plain(f1, levels, coords, radius, torch.float32)
    if dtype == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert torch.all((out.float() - ref).abs() <= _bf16_step(ref) + 2e-5 * ref.abs().max())
    assert torch.all(out[:, : hw[1]] == 0)  # the far row
    if levels[-1].shape[1] == 0:
        assert torch.all(out[..., -((2 * radius + 1) ** 2):] == 0)
    gen = torch.Generator(device="cuda").manual_seed(radius)
    g = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    df1 = co.corr_ondemand_bwd_df1(levels, coords, g, radius)
    assert df1.dtype == torch.float32
    assert _max_rel(df1, co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius)) <= 2e-5
    shapes = [tuple(f.shape[1:3]) for f in levels]
    df2 = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius)
    for a, b in zip(df2, co.corr_ondemand_bwd_df2_plain(f1, coords, g, shapes, radius)):
        assert a.shape == b.shape and a.dtype == torch.float32
        if b.numel():
            assert _max_rel(a, b) <= 2e-5
    assert co.LAUNCHES == {"corr_ondemand_fwd": 1, "corr_ondemand_bwd_df1": 1,
                           "corr_ondemand_bwd_df2": 1, "corr_ondemand_df2_plan": 1}


def _tiling_coords(kind, B, h, w, seed):
    """Coords [B, h*w, 2] that stress K4's query tiles (4 x 16 queries of
    the h x w grid) and K6's row runs: `ragged` (h, w not multiples of the
    tile), `border` (tiles straddling the right and top borders), `far_one`
    (one query at +-1e6 among in-bounds neighbours), `uniform` (spread over
    the whole level: the widest box), `smooth` (grid + a bilinear 4x8 field
    of +-8 px)."""
    rng = np.random.RandomState(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    grid = np.stack([gx, gy], -1)[None].repeat(B, 0).astype(np.float32)
    if kind == "uniform":
        c = rng.uniform(0, 1, grid.shape).astype(np.float32) * np.float32([w, h])
    elif kind == "smooth":
        field = torch.from_numpy(rng.uniform(-8, 8, (B, 2, 4, 8)).astype(np.float32))
        c = grid + torch.nn.functional.interpolate(
            field, size=(h, w), mode="bilinear", align_corners=True).permute(0, 2, 3, 1).numpy()
    else:
        c = grid + rng.uniform(-3, 3, grid.shape).astype(np.float32)
    c = c.reshape(B, h * w, 2)
    if kind == "border":
        c[:, :64, 0] = w - 1 + rng.uniform(-2.5, 2.5, (B, 64)).astype(np.float32)
        c[:, :64, 1] = rng.uniform(-1.5, 1.5, (B, 64)).astype(np.float32)
    if kind == "far_one":
        c[:, 70] += 1.0e6
        c[:, 75] -= 1.0e6
    return torch.from_numpy(np.ascontiguousarray(c))


TILING_SHAPES = {"ragged": (9, 13), "border": (8, 24), "far_one": (8, 16),
                 "uniform": (6, 128), "smooth": (12, 40)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,radius", [(128, 3), (256, 4), (128, 4), (256, 3)])
@pytest.mark.parametrize("kind", sorted(TILING_SHAPES))
def test_ondemand_tiling_cases(cuda, kind, C, radius, dtype):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    h, w = TILING_SHAPES[kind]
    f1, levels, _ = _ondemand_case(cuda, h, w, C, dtype, seed=radius + C, far=False)
    coords = _tiling_coords(kind, 2, h, w, seed=len(kind) + radius).to(cuda)
    co.reset_launches()
    out = co.corr_ondemand_fwd(f1, levels, coords, radius, dtype)
    routes = co.corr_ondemand_fwd_routes()
    ref = co.corr_ondemand_fwd_plain(f1, levels, coords, radius, torch.float32)
    if dtype == torch.float32:
        assert _max_rel(out, ref) <= 2e-5
    else:
        assert torch.all((out.float() - ref).abs() <= _bf16_step(ref) + 2e-5 * ref.abs().max())
    assert routes["tiles"] == 2 * -(-w // 16) * -(-h // 4)  # tiles of 4 x 16 queries, either dtype
    if kind == "uniform":  # level 0's box (128 columns) is wider than a tile stages
        assert routes["per_query"] >= 1
    if kind == "smooth":
        assert routes["per_query"] == 0 and routes["tiled"] == routes["tiles"] * 4
    if kind == "far_one":
        assert torch.all(out[:, [70, 75]] == 0)
    gen = torch.Generator(device="cuda").manual_seed(radius)
    g = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    shapes = [tuple(f.shape[1:3]) for f in levels]
    entries, starts = co.corr_ondemand_df2_plan(coords, shapes, radius)
    ref_entries, ref_starts = co.corr_ondemand_df2_plan_plain(coords, shapes, radius)
    assert torch.equal(starts, ref_starts)
    for lvl, (hl, wl) in enumerate(shapes):  # the pairs; the kernel writes no more
        for bb in range(2):
            n = int(ref_starts[bb, lvl, hl]) if hl > 0 and wl > 0 else 0
            assert torch.equal(entries[bb, lvl, :n], ref_entries[bb, lvl, :n])
    df2 = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius)
    again = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius)
    assert all(torch.equal(a, b) for a, b in zip(df2, again))
    for a, b in zip(df2, co.corr_ondemand_bwd_df2_plain(f1, coords, g, shapes, radius)):
        assert a.shape == b.shape and (b.numel() == 0 or _max_rel(a, b) <= 2e-5)
    assert co.LAUNCHES == {"corr_ondemand_fwd": 1, "corr_ondemand_bwd_df1": 0,
                           "corr_ondemand_bwd_df2": 2, "corr_ondemand_df2_plan": 3}


def _fp32_routes_case(kind, C, radius):
    """fp32 operands for K4's and K5's fp32 tiles: a TILING_SHAPES kind (its
    coords), `rows` (Q != H0 * W0: the first 9*13 - 3 queries of the ragged
    grid, tiles of rows of 16 consecutive queries) or `empty_level` (a 7x16
    map: the coarsest level is 0x2, and a far row)."""
    cuda = torch.device("cuda")
    if kind == "empty_level":
        return _ondemand_case(cuda, 7, 16, C, torch.float32, seed=C + radius)
    h, w = (9, 13) if kind == "rows" else TILING_SHAPES[kind]
    f1, levels, _ = _ondemand_case(cuda, h, w, C, torch.float32, seed=radius + C, far=False)
    coords = _tiling_coords("ragged" if kind == "rows" else kind, 2, h, w,
                            seed=len(kind) + radius).to(cuda)
    if kind == "rows":
        f1, coords = f1[:, : h * w - 3].contiguous(), coords[:, : h * w - 3].contiguous()
    return f1, levels, coords


@pytest.mark.parametrize("C,radius", [(128, 3), (256, 4), (128, 4), (256, 3)])
@pytest.mark.parametrize("kind", sorted(TILING_SHAPES) + ["empty_level", "rows"])
def test_ondemand_fp32_tiles(cuda, kind, C, radius):
    """K4 and K5 with fp32 operands (the fp32 tiles: three TF32 passes on
    the tensor cores) against their plain versions at max_rel 2e-5 on each
    input set that could break the tiles, the route record of the fp32
    launch, and each kernel twice, bit for bit (every output written once)."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    f1, levels, coords = _fp32_routes_case(kind, C, radius)
    B, Q, _ = coords.shape
    co.reset_launches()
    out = co.corr_ondemand_fwd(f1, levels, coords, radius, torch.float32)
    routes = co.corr_ondemand_fwd_routes()
    assert _max_rel(out, co.corr_ondemand_fwd_plain(f1, levels, coords, radius)) <= 2e-5
    assert torch.equal(out, co.corr_ondemand_fwd(f1, levels, coords, radius, torch.float32))
    h0, w0 = levels[0].shape[1:3]
    grid_w = w0 if Q == h0 * w0 else 16
    assert routes["tiles"] == B * -(-grid_w // 16) * -(-(-(-Q // grid_w)) // 4)
    assert routes["tiled"] + routes["per_query"] == routes["tiles"] * sum(
        f.shape[1] > 0 and f.shape[2] > 0 for f in levels)
    if kind == "uniform":
        assert routes["per_query"] >= 1
    if kind in ("smooth", "ragged", "rows"):
        assert routes["per_query"] == 0
    if kind == "empty_level":
        assert levels[-1].shape[1] == 0 and torch.all(out[..., -((2 * radius + 1) ** 2):] == 0)
        assert torch.all(out[:, :16] == 0)  # the far row
    gen = torch.Generator(device="cuda").manual_seed(C + radius)
    for g_dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(out.shape, device=cuda, generator=gen).to(g_dtype)
        df1 = co.corr_ondemand_bwd_df1(levels, coords, g, radius)
        assert df1.dtype == torch.float32 and df1.shape == (B, Q, C)
        assert _max_rel(df1, co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius)) <= 2e-5
        assert torch.equal(df1, co.corr_ondemand_bwd_df1(levels, coords, g, radius))
        if kind == "empty_level":
            assert torch.all(df1[:, :16] == 0)
    assert co.LAUNCHES["corr_ondemand_fwd"] == 2 and co.LAUNCHES["corr_ondemand_bwd_df1"] == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ondemand_slab_matches_frame(cuda, dtype):
    """A 16-row slab of a 32x40 frame's queries, given the frame's grid
    width, gets from K4 and K5 each value of the whole frame's call bit for
    bit (the spatial split's contract): its tiles are the frame's tiles."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    h, w, radius = 32, 40, 4
    f1, levels, _ = _ondemand_case(cuda, h, w, 256, dtype, seed=11, far=False)
    coords = _tiling_coords("smooth", 2, h, w, seed=12).to(cuda)
    coords[:, 5 * w: 5 * w + 3] += 1.0e6  # a far query in a tile of the slab's frame rows
    out = co.corr_ondemand_fwd(f1, levels, coords, radius, dtype)
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    df1 = co.corr_ondemand_bwd_df1(levels, coords, g, radius)
    for r0 in (0, 16):
        sl = slice(r0 * w, (r0 + 16) * w)
        f1s, cs, gs = (t[:, sl].contiguous() for t in (f1, coords, g))
        assert torch.equal(co.corr_ondemand_fwd(f1s, levels, cs, radius, dtype, grid_w=w), out[:, sl])
        assert torch.equal(co.corr_ondemand_bwd_df1(levels, cs, gs, radius, grid_w=w), df1[:, sl])


DF1_GRIDS = [(46, 62), (7, 16), (1, 5)]


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,radius", [(128, 3), (256, 4), (128, 4), (256, 3)])
@pytest.mark.parametrize("hw", DF1_GRIDS)
def test_ondemand_df1_bf16_tiles(cuda, hw, C, radius, g_dtype):
    """K5 with bf16 fmap2 (K4's tiles, drows x staged pixels on the tensor
    cores in three bf16 pieces) against its plain version: query grids that
    are no multiple of the 4 x 16 tile, 7x16 with an empty coarsest level,
    1x5 with three empty levels, and (but for 1x5) a row of far
    out-of-bounds queries, which must get no gradient; and run twice, bit
    for bit (each element is written once, by one thread)."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    h, w = hw
    f1, levels, coords = _ondemand_case(cuda, h, w, C, torch.bfloat16, seed=h * w + C + radius,
                                        far=h > 1)
    B, Q, _ = coords.shape
    if hw == (7, 16):
        assert levels[-1].shape[1] == 0
    gen = torch.Generator(device="cuda").manual_seed(radius)
    g = torch.randn(B, Q, 4 * (2 * radius + 1) ** 2, device=cuda, generator=gen).to(g_dtype)
    co.reset_launches()
    df1 = co.corr_ondemand_bwd_df1(levels, coords, g, radius)
    assert co.LAUNCHES["corr_ondemand_bwd_df1"] == 1
    assert df1.dtype == torch.float32 and df1.shape == (B, Q, C)
    assert _max_rel(df1, co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius)) <= 2e-5
    if h > 1:
        assert torch.all(df1[:, :w] == 0)  # the far row
    assert torch.equal(df1, co.corr_ondemand_bwd_df1(levels, coords, g, radius))  # no atomics


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["rows", "uniform"])
def test_ondemand_df1_bf16_other_routes(cuda, kind, g_dtype):
    """K5's bf16 kernel off the level-0 grid: `rows`, Q != H0 * W0 (tiles of
    rows of 16 consecutive queries, a ragged last one); `uniform`, coords
    spread over a 6x128 level, whose boxes are too wide to stage (the
    per-query route at level 0)."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    h, w = (9, 13) if kind == "rows" else TILING_SHAPES["uniform"]
    f1, levels, _ = _ondemand_case(cuda, h, w, 256, torch.bfloat16, seed=len(kind), far=False)
    coords = _tiling_coords("ragged" if kind == "rows" else "uniform", 2, h, w, seed=4).to(cuda)
    if kind == "rows":
        coords = coords[:, : h * w - 3].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(1)
    g = torch.randn(2, coords.shape[1], 4 * 81, device=cuda, generator=gen).to(g_dtype)
    df1 = co.corr_ondemand_bwd_df1(levels, coords, g, 4)
    assert _max_rel(df1, co.corr_ondemand_bwd_df1_plain(levels, coords, g, 4)) <= 2e-5
    if kind == "uniform":  # the forward's tiles take the per-query route too
        co.corr_ondemand_fwd(f1, levels, coords, 4, torch.bfloat16)
        assert co.corr_ondemand_fwd_routes()["per_query"] >= 1


def test_ondemand_df2_is_deterministic(cuda):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    f1, levels, coords = _ondemand_case(cuda, 46, 62, 256, torch.bfloat16, seed=3, B=4, far=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(4, 46 * 62, 4 * 81, device=cuda, generator=gen).bfloat16()
    shapes = [tuple(f.shape[1:3]) for f in levels]
    first = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, 4)
    again = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, 4)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_ondemand_function_on_card(cuda):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    f1, levels, coords = _ondemand_case(cuda, 9, 12, 128, torch.bfloat16, seed=4)
    fmap1 = f1.reshape(2, 9, 12, 128).detach().requires_grad_()
    tl = [f.detach().requires_grad_() for f in levels]
    co.reset_launches()
    out = co.ondemand_corr_pyramid_cuda(fmap1, tl, coords.reshape(2, 9, 12, 2), 3, torch.bfloat16)
    out.float().square().sum().backward()
    assert co.LAUNCHES == {"corr_ondemand_fwd": 1, "corr_ondemand_bwd_df1": 1,
                           "corr_ondemand_bwd_df2": 1, "corr_ondemand_df2_plan": 1}
    assert fmap1.grad.dtype == torch.bfloat16 and all(p.grad.dtype == torch.bfloat16 for p in tl)
    assert torch.isfinite(fmap1.grad.float()).all()


def _gru_case(device, B, H, W, dtype, seed, X=256, D=128):
    """h (tanh of normals), x (relu of normals) NHWC and the six gates'
    (weight OIHW, bias), PyTorch's default conv init bound."""
    from raft_optical_flow_tpu_torch.kernels.gru_fused import GATES

    rng = np.random.RandomState(seed)
    h = torch.from_numpy(np.tanh(rng.randn(B, H, W, D)).astype(np.float32))
    x = torch.from_numpy(np.maximum(rng.randn(B, H, W, X), 0).astype(np.float32))
    bound = 1.0 / np.sqrt(5 * (D + X))
    weights = []
    for name in GATES:
        ks = (1, 5) if name.endswith("1") else (5, 1)
        w = rng.uniform(-bound, bound, (D, D + X, *ks)).astype(np.float32)
        weights.append(torch.from_numpy(w))
        weights.append(torch.from_numpy(rng.uniform(-bound, bound, D).astype(np.float32)))
    return h.to(device, dtype), x.to(device, dtype), [w.to(device) for w in weights]


def _check_gru_pass_bf16(got, ref, w):
    """One rounding step plus one flipped rh rounding through the q gate's
    largest weight (columns 2D.. of w), plus 2e-5 * max|ref|."""
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    got, ref = got.float(), ref.float()
    slack = 2.0**-8 * float(w[:, :, 256:].float().abs().max()) + 2e-5 * float(ref.abs().max())
    assert torch.all((got - ref).abs() <= _bf16_step(ref) + slack)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,X", [
    (16, 55, 128, 256), (1, 55, 128, 256), (1, 8, 37, 256), (1, 7, 37, 256),
    (2, 5, 100, 256), (3, 5, 5, 256), (1, 1, 9, 256), (1, 9, 1, 256), (1, 3, 300, 256),
    (2, 13, 70, 144), (2, 46, 62, 256),
])
def test_gru_pass_matches_plain(cuda, B, H, W, X, dtype):
    """Both passes against the plain version. 16x55x128: the serving shape
    (the 5x1 pass's 55-long columns two to a block, the 1x5 pass's 128-long
    rows one to a block) and 1x55x128 its batch-1 form; 8x37 and 7x37: 37-long
    rows two to a block (7 rows: the last block half empty); 5x100: rows of
    63..128, a block each, and 5-long columns packed twelve to a warpgroup;
    5x5 both ways short; 1-high and 1-wide: every tap but the centre is
    padding in one of the passes; 3x300: rows cut into segments of 124 with a
    2-position halo; 13x70 at X = 144, another multiple of 16; 2x46x62 the
    fp32 training shape (fp32: 5,704 positions in blocks of 48 rows that run
    across lines)."""
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    h, x, weights = _gru_case(cuda, B, H, W, dtype, seed=H * W + X, X=X)
    gf.reset_launches()
    for axis, part in ((2, weights[:6]), (1, weights[6:])):
        w, b = gf.pass_weights(part, dtype)
        got = gf.gru_pass(h, x, w, b, axis)
        ref = gf.gru_pass_plain(h, x, w, b, axis)
        if dtype == torch.float32:
            assert _max_rel(got, ref) <= 1e-5, axis
        else:
            _check_gru_pass_bf16(got, ref, w)
        h = ref
    assert gf.LAUNCHES == {"sepconv_gru_pass": 2}


# sha256 of K7's fp32 outputs in test_gru_pass_fp32_keeps_its_bits, as the
# strip kernel that the fp32 GEMM route replaced gave them on the card
K7_FP32_DIGEST = "f37c61469ab3278e7b02e13c36470ecbdc15dc952a39f66c16eb314758f24f1a"


def test_gru_pass_fp32_keeps_its_bits(cuda):
    """K7's fp32 route sums each output in the order of the strip kernel it
    replaced (taps ascending, then channels ascending, one fmaf chain from 0)
    and keeps its gate arithmetic, so its outputs are that kernel's bits:
    both passes of each shape (the training and serving shapes, ragged and
    1-wide lines, 300-long rows, X = 144), each pass fed the last one's
    output, hash to the digest of that kernel's outputs on these inputs."""
    import hashlib

    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    digest = hashlib.sha256()
    for B, H, W, X in ((2, 46, 62, 256), (1, 55, 128, 256), (1, 8, 37, 256), (2, 37, 1, 256),
                       (1, 3, 300, 256), (3, 5, 5, 256), (2, 13, 70, 144)):
        h, x, weights = _gru_case(cuda, B, H, W, torch.float32, seed=H * W + X, X=X)
        for axis, part in ((2, weights[:6]), (1, weights[6:])):
            w, b = gf.pass_weights(part, torch.float32)
            h = gf.gru_pass(h, x, w, b, axis)
            digest.update(h.cpu().numpy().tobytes())
    assert digest.hexdigest() == K7_FP32_DIGEST


def test_sepconv_gru_function_backward_on_card(cuda):
    """Forward K7 (two launches); backward autograd of the reference on the
    saved inputs: the same gradients as differentiating the reference itself."""
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    h, x, weights = _gru_case(cuda, 1, 8, 37, torch.float32, seed=5)
    leaves = [t.permute(0, 3, 1, 2).requires_grad_() for t in (h, x)]
    leaves += [w.requires_grad_() for w in weights]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with gf._full_fp32():
            gf.reset_launches()
            out = gf.SepConvGRUFused.apply(*leaves)
            assert gf.LAUNCHES == {"sepconv_gru_pass": 2}
            ref = gf._reference_nchw(leaves[0], leaves[1], leaves[2:])
            assert _max_rel(out, ref) <= 1e-5
            g = torch.randn_like(ref)
            got = torch.autograd.grad(out, leaves, g)
            want = torch.autograd.grad(ref, leaves, g)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for a, b in zip(got, want):
        assert _max_rel(a, b) <= 1e-6


@pytest.mark.parametrize("vol_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(15, 22), (7, 16)])
def test_all_levels_matches_plain(cuda, hw, vol_dtype):
    pyr, coords = _case(cuda, *hw, vol_dtype, seed=hw[0])
    if hw == (7, 16):
        assert pyr[-1].shape[2] == 0
    for radius in (3, 4):
        ck.reset_launches()
        got = ck.corr_pyramid_lookup_cuda_fused(pyr, coords, radius)
        assert ck.LAUNCHES["corr_lookup_all_levels"] == 1
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ck.corr_pyramid_lookup_fused_plain(pyr, coords, radius),
                                   rtol=0, atol=0)
        if hw == (7, 16):
            assert torch.all(got[..., -((2 * radius + 1) ** 2):] == 0)
