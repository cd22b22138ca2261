"""On-demand windowed correlation (alt_cuda_corr): no all-pairs volume.

Counterpart of `raft_optical_flow_tpu/kernels/corr_ondemand.py` (the
blockwise XLA path and the dispatcher `ondemand_corr_pyramid`) and of
`raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py` (its TPU kernels).
For each query q and pyramid level l,

    out[b, q, l*K^2 + k] = <f1[b, q], bilinear_zero(f2_l[b], coords[b, q] / 2^l + off_k)> / sqrt(C)

with window channel k = a*K + b and offset (dx, dy) = (a - r, b - r), taps
outside the level reading 0; computed from the feature maps, never from the
HW x HW volume. Three CUDA kernels (`csrc/corr_ondemand.cu`, built by
`_build.py`, bound through ctypes):

  - K4 `corr_ondemand_fwd`: the windows of every level in one launch
    (replaces `_fwd_level_kernel` and `_fwd_level_stream_kernel`);
  - K5 `corr_ondemand_bwd_df1`: the fmap1 gradient (replaces
    `_bwd_df1_kernel`, `_bwd_df1_stream_kernel`);
  - K6 `corr_ondemand_bwd_df2`: the gradient of every fmap2 level, summed
    over queries in a fixed order, no atomics (replaces `_bwd_df2_kernel`,
    `_bwd_df2_stream_kernel`).

`OndemandCorr` is the autograd Function (forward K4, backward K5 and K6; no
coords gradient, as the JAX package returns zeros). For a CUDA tensor each
wrapper launches its kernel or raises; for a CPU tensor it runs its plain
version, the blockwise formulation of the JAX package's `_ondemand` (query
tiles of 128, two separable tri-selector products per tile and level),
which is also the kernels' oracle and keeps memory at O(128 * Hl * Wl).
Each wrapper counts its launches in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from raft_optical_flow_tpu_torch.kernels import _build

# launches of each kernel since the last reset_launches(); plain runs do not count
LAUNCHES: Dict[str, int] = {
    "corr_ondemand_fwd": 0, "corr_ondemand_bwd_df1": 0, "corr_ondemand_bwd_df2": 0,
}

QT = 128  # query tile of the plain version (the JAX package's XLA default)
MAX_LEVELS = 8
KERNEL_CHANNELS = (128, 256)  # fmap widths the kernels take: RAFT-small, RAFT-standard
KERNEL_RADII = (3, 4)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.raft_corr_ondemand_fwd.argtypes = [P, P, P, P, I, P, P, I, I, I, I, I, I, P]
        lib.raft_corr_ondemand_fwd.restype = I
        lib.raft_corr_ondemand_bwd_df1.argtypes = [P, P, P, I, P, P, P, I, I, I, I, I, I, P]
        lib.raft_corr_ondemand_bwd_df1.restype = I
        lib.raft_corr_ondemand_bwd_df2.argtypes = [P, P, P, I, P, P, P, I, I, I, I, I, I, P]
        lib.raft_corr_ondemand_bwd_df2.restype = I
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# argument checks


def _check_coords(coords: torch.Tensor, B: int, Q: int, radius: int) -> None:
    if tuple(coords.shape) != (B, Q, 2) or coords.dtype != torch.float32:
        raise ValueError(f"coords must be float32 [{B}, {Q}, 2], got {coords.dtype} "
                         f"{tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")


def _check_levels(levels: Sequence[torch.Tensor], B: int, C: int, dtype, device) -> None:
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} fmap2 levels, got {len(levels)}")
    for f in levels:
        if f.dim() != 4 or f.shape[0] != B or f.shape[3] != C:
            raise ValueError(f"fmap2 levels must be [B={B}, Hl, Wl, C={C}], got {tuple(f.shape)}")
        if f.dtype != dtype or f.device != device or not f.is_contiguous():
            raise ValueError("fmap2 levels must be contiguous, on one device, in one dtype "
                             "with fmap1")


def _check_g(g: torch.Tensor, B: int, Q: int, n: int, device) -> None:
    if tuple(g.shape) != (B, Q, n) or g.dtype not in _DTYPE_CODE:
        raise ValueError(f"g must be float32/bfloat16 [{B}, {Q}, {n}], got {g.dtype} "
                         f"{tuple(g.shape)}")
    if g.device != device or not g.is_contiguous():
        raise ValueError("g must be contiguous and on the coords' device")


def _check_kernel_args(C: int, radius: int, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take beyond the plain version: RAFT's widths and
    radii (templates), and 16-byte aligned rows for their vector loads."""
    if C not in KERNEL_CHANNELS or radius not in KERNEL_RADII:
        raise ValueError(f"the CUDA kernels take C in {KERNEL_CHANNELS} and radius in "
                         f"{KERNEL_RADII}, got C={C}, radius={radius}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernels need 16-byte aligned tensors")


def _level_arrays(tensors: Sequence[torch.Tensor]):
    n = len(tensors)
    ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors])
    hs = (ctypes.c_int * n)(*[t.shape[1] for t in tensors])
    ws = (ctypes.c_int * n)(*[t.shape[2] for t in tensors])
    return ptrs, hs, ws


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)


def _tri(c: torch.Tensor, n: int, radius: int) -> torch.Tensor:
    """S[..., d, a] = max(0, 1 - |d - (c - r + a)|), for centres c [...]:
    the bilinear weight window column (row) a gives pixel d, 0 outside."""
    d = torch.arange(n, dtype=torch.float32, device=c.device)
    a = torch.arange(2 * radius + 1, dtype=torch.float32, device=c.device)
    t = d[:, None] - (c[..., None, None] - float(radius) + a)
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _selectors(c_t: torch.Tensor, lvl: int, Hl: int, Wl: int, radius: int):
    cx = c_t[..., 0] / (2.0**lvl)
    cy = c_t[..., 1] / (2.0**lvl)
    return _tri(cx, Wl, radius), _tri(cy, Hl, radius)  # [B, QT, Wl, K], [B, QT, Hl, K]


def corr_ondemand_fwd_plain(f1: torch.Tensor, levels: Sequence[torch.Tensor],
                            coords: torch.Tensor, radius: int,
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K4: f1 [B, Q, C], levels [B, Hl, Wl, C], coords
    [B, Q, 2] level-0 -> [B, Q, L*K^2] out_dtype. Operands are taken to fp32
    (bf16 operands are exact there), fp32 products and sums, one rounding."""
    B, Q, C = f1.shape
    K = 2 * radius + 1
    f1 = f1.float()
    f2s = [f.float() for f in levels]
    out = torch.empty(B, Q, len(levels) * K * K, dtype=torch.float32, device=f1.device)
    for q0 in range(0, Q, QT):
        f1_t, c_t = f1[:, q0:q0 + QT], coords[:, q0:q0 + QT].float()
        for lvl, f2 in enumerate(f2s):
            Hl, Wl = f2.shape[1:3]
            rows = torch.einsum("bqc,bhwc->bqhw", f1_t, f2)
            X, Y = _selectors(c_t, lvl, Hl, Wl, radius)
            u = torch.einsum("bqwa,bqhw->bqah", X, rows)
            win = torch.einsum("bqah,bqhk->bqak", u, Y)
            out[:, q0:q0 + QT, lvl * K * K:(lvl + 1) * K * K] = win.reshape(B, -1, K * K)
    return (out / torch.sqrt(torch.tensor(float(C)))).to(out_dtype)


def _drows_tiles(coords: torch.Tensor, g: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                 radius: int, C: int):
    """Yield (q0, lvl, d_rows [B, QT, Hl, Wl]) with d_rows = X g Y^T, the
    window cotangent (scaled by 1/sqrt(C)) spread back onto each query's taps."""
    B, Q, _ = coords.shape
    K = 2 * radius + 1
    gs = g.float() * (1.0 / torch.sqrt(torch.tensor(float(C))))
    for q0 in range(0, Q, QT):
        c_t = coords[:, q0:q0 + QT].float()
        for lvl, (Hl, Wl) in enumerate(shapes):
            g_l = gs[:, q0:q0 + QT, lvl * K * K:(lvl + 1) * K * K].reshape(B, -1, K, K)
            X, Y = _selectors(c_t, lvl, Hl, Wl, radius)
            t = torch.einsum("bqak,bqhk->bqah", g_l, Y)
            yield q0, lvl, torch.einsum("bqah,bqwa->bqhw", t, X)


def corr_ondemand_bwd_df1_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                                g: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of K5: df1 [B, Q, C] fp32 = sum_l d_rows_l . f2_l."""
    B, Q, _ = coords.shape
    C = levels[0].shape[3]
    f2s = [f.float() for f in levels]
    df1 = torch.zeros(B, Q, C, dtype=torch.float32, device=coords.device)
    shapes = [tuple(f.shape[1:3]) for f in levels]
    for q0, lvl, d_rows in _drows_tiles(coords, g, shapes, radius, C):
        df1[:, q0:q0 + QT] += torch.einsum("bqhw,bhwc->bqc", d_rows, f2s[lvl])
    return df1


def corr_ondemand_bwd_df2_plain(f1: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                                shapes: Sequence[Tuple[int, int]],
                                radius: int) -> List[torch.Tensor]:
    """Plain version of K6: df2_l [B, Hl, Wl, C] fp32 = sum_q d_rows_l^T . f1."""
    B, Q, C = f1.shape
    f1 = f1.float()
    df2s = [torch.zeros(B, Hl, Wl, C, dtype=torch.float32, device=f1.device) for Hl, Wl in shapes]
    for q0, lvl, d_rows in _drows_tiles(coords, g, shapes, radius, C):
        df2s[lvl] += torch.einsum("bqhw,bqc->bhwc", d_rows, f1[:, q0:q0 + QT])
    return df2s


# ---------------------------------------------------------------------------
# kernel wrappers


def corr_ondemand_fwd(f1: torch.Tensor, levels: Sequence[torch.Tensor], coords: torch.Tensor,
                      radius: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4: on-demand windows of every level in one launch.

    f1: [B, Q, C] fp32 or bf16; levels: [B, Hl, Wl, C] in f1's dtype (empty
    levels allowed); coords: [B, Q, 2] fp32 level-0 (x, y); all contiguous.
    Returns [B, Q, L*(2r+1)^2] out_dtype (fp32 sums, one rounding), levels
    concatenated coarse-last, zeros for an empty level.
    """
    B, Q, C = f1.shape
    _check_coords(coords, B, Q, radius)
    if f1.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"f1 and out_dtype must be float32 or bfloat16, got {f1.dtype}, {out_dtype}")
    if f1.device != coords.device or not f1.is_contiguous():
        raise ValueError("f1 must be contiguous and on the coords' device")
    _check_levels(levels, B, C, f1.dtype, f1.device)
    if not f1.is_cuda:
        return corr_ondemand_fwd_plain(f1, levels, coords, radius, out_dtype)
    _check_kernel_args(C, radius, f1, *levels)
    K = 2 * radius + 1
    out = torch.empty(B, Q, len(levels) * K * K, dtype=out_dtype, device=f1.device)
    if B * Q == 0:
        return out
    ptrs, hs, ws = _level_arrays(levels)
    lib = _kernels()
    with torch.cuda.device(f1.device):
        err = lib.raft_corr_ondemand_fwd(
            f1.data_ptr(), ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
            len(levels), coords.data_ptr(), out.data_ptr(), B, Q, C, radius,
            _DTYPE_CODE[f1.dtype], _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_ondemand_fwd")
    LAUNCHES["corr_ondemand_fwd"] += 1
    return out


def corr_ondemand_bwd_df1(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                          g: torch.Tensor, radius: int) -> torch.Tensor:
    """K5: the fmap1 gradient of K4, all levels in one launch.

    levels: [B, Hl, Wl, C] fp32 or bf16 (one dtype, contiguous); coords:
    [B, Q, 2] fp32 level-0; g: [B, Q, L*(2r+1)^2] fp32 or bf16, K4's output
    cotangent. Returns df1 [B, Q, C] fp32 (fp32 sums, no atomics).
    """
    B, Q, _ = coords.shape
    if not levels or levels[0].dim() != 4:
        raise ValueError("fmap2 levels must be [B, Hl, Wl, C] tensors")
    C = levels[0].shape[3]
    _check_coords(coords, B, Q, radius)
    _check_levels(levels, B, C, levels[0].dtype, coords.device)
    if levels[0].dtype not in _DTYPE_CODE:
        raise TypeError(f"fmap2 levels must be float32 or bfloat16, got {levels[0].dtype}")
    _check_g(g, B, Q, len(levels) * (2 * radius + 1) ** 2, coords.device)
    if not coords.is_cuda:
        return corr_ondemand_bwd_df1_plain(levels, coords, g, radius)
    _check_kernel_args(C, radius, *levels)
    df1 = torch.empty(B, Q, C, dtype=torch.float32, device=coords.device)
    if B * Q == 0:
        return df1
    ptrs, hs, ws = _level_arrays(levels)
    lib = _kernels()
    with torch.cuda.device(coords.device):
        err = lib.raft_corr_ondemand_bwd_df1(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws), len(levels),
            coords.data_ptr(), g.data_ptr(), df1.data_ptr(), B, Q, C, radius,
            _DTYPE_CODE[levels[0].dtype], _DTYPE_CODE[g.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_ondemand_bwd_df1")
    LAUNCHES["corr_ondemand_bwd_df1"] += 1
    return df1


def corr_ondemand_bwd_df2(f1: torch.Tensor, coords: torch.Tensor, g: torch.Tensor,
                          shapes: Sequence[Tuple[int, int]], radius: int) -> List[torch.Tensor]:
    """K6: the gradient of every fmap2 level of K4, in one launch.

    f1: [B, Q, C] fp32 or bf16, contiguous; coords: [B, Q, 2] fp32 level-0;
    g: [B, Q, L*(2r+1)^2] fp32 or bf16; shapes: (Hl, Wl) of each level.
    Returns df2_l [B, Hl, Wl, C] fp32 per level. Each element sums its
    queries' contributions in query order: the same bits from run to run.
    """
    B, Q, C = f1.shape
    _check_coords(coords, B, Q, radius)
    if f1.dtype not in _DTYPE_CODE:
        raise TypeError(f"f1 must be float32 or bfloat16, got {f1.dtype}")
    if f1.device != coords.device or not f1.is_contiguous():
        raise ValueError("f1 must be contiguous and on the coords' device")
    if not 1 <= len(shapes) <= MAX_LEVELS or any(h < 0 or w < 0 for h, w in shapes):
        raise ValueError(f"1..{MAX_LEVELS} level shapes >= 0, got {list(shapes)}")
    _check_g(g, B, Q, len(shapes) * (2 * radius + 1) ** 2, coords.device)
    if not coords.is_cuda:
        return corr_ondemand_bwd_df2_plain(f1, coords, g, shapes, radius)
    _check_kernel_args(C, radius, f1)
    df2s = [torch.empty(B, Hl, Wl, C, dtype=torch.float32, device=f1.device)
            for Hl, Wl in shapes]
    if B * Q == 0:
        for d in df2s:
            d.zero_()
        return df2s
    if all(d.numel() == 0 for d in df2s):
        return df2s
    ptrs, hs, ws = _level_arrays(df2s)
    lib = _kernels()
    with torch.cuda.device(f1.device):
        err = lib.raft_corr_ondemand_bwd_df2(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws), len(df2s),
            coords.data_ptr(), g.data_ptr(), f1.data_ptr(), B, Q, C, radius,
            _DTYPE_CODE[f1.dtype], _DTYPE_CODE[g.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_ondemand_bwd_df2")
    LAUNCHES["corr_ondemand_bwd_df2"] += 1
    return df2s


# ---------------------------------------------------------------------------
# autograd and the dispatcher


class OndemandCorr(torch.autograd.Function):
    """K4 with K5 and K6 as its backward (or, with impl='plain', their plain
    versions on any device).

    apply(impl, f1, coords, radius, out_dtype, *levels) -> [B, Q, L*(2r+1)^2];
    f1 [B, Q, C], coords [B, Q, 2] fp32, levels [B, Hl, Wl, C], each level a
    tensor argument of its own so autograd sees it. Saves only its inputs, so
    non-reentrant `torch.utils.checkpoint` recomputes K4 in the backward. The
    gradients come out of K5 and K6 in fp32 and are cast to the inputs'
    dtypes; the coords gradient is None (RAFT detaches coords before every
    lookup; the JAX package returns zeros).
    """

    @staticmethod
    def forward(ctx, impl, f1, coords, radius, out_dtype, *levels):
        ctx.save_for_backward(f1, coords, *levels)
        ctx.impl, ctx.radius = impl, radius
        return _IMPLS[impl][0](f1, levels, coords, radius, out_dtype)

    @staticmethod
    def backward(ctx, g):
        f1, coords, *levels = ctx.saved_tensors
        _, bwd_df1, bwd_df2 = _IMPLS[ctx.impl]
        g = g.contiguous()
        df1 = None
        if ctx.needs_input_grad[1]:
            df1 = bwd_df1(levels, coords, g, ctx.radius).to(f1.dtype)
        df2s = [None] * len(levels)
        if any(ctx.needs_input_grad[5:]):
            shapes = [tuple(f.shape[1:3]) for f in levels]
            df2s = [d.to(f.dtype) for d, f in zip(bwd_df2(f1, coords, g, shapes, ctx.radius),
                                                  levels)]
        return (None, df1, None, None, None, *df2s)


_IMPLS = {
    "cuda": (corr_ondemand_fwd, corr_ondemand_bwd_df1, corr_ondemand_bwd_df2),
    "plain": (corr_ondemand_fwd_plain, corr_ondemand_bwd_df1_plain, corr_ondemand_bwd_df2_plain),
}


def _pyramid(impl, fmap1, f2_levels, coords, radius, out_dtype):
    B, h, w, C = fmap1.shape
    f1 = fmap1.reshape(B, h * w, C).contiguous()
    flat = coords.reshape(B, h * w, 2).float().contiguous()
    out = OndemandCorr.apply(impl, f1, flat, radius, out_dtype,
                             *[f.contiguous() for f in f2_levels])
    return out.reshape(B, h, w, -1)


def ondemand_corr_pyramid_cuda(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                               coords: torch.Tensor, radius: int,
                               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """On-demand multi-level windowed correlation through K4 (K5, K6 backward).

    The signature of the JAX dispatcher `ondemand_corr_pyramid`: fmap1
    [B, h, w, C]; f2_levels [B, Hl, Wl, C] per level (level 0 at fmap
    resolution, fmap1's dtype); coords [B, h, w, 2] level-0 (x, y).
    Returns [B, h, w, L*(2r+1)^2] out_dtype, levels concatenated coarse-last.
    """
    return _pyramid("cuda", fmap1, f2_levels, coords, radius, out_dtype)


def ondemand_corr_pyramid_plain(fmap1: torch.Tensor, f2_levels: Sequence[torch.Tensor],
                                coords: torch.Tensor, radius: int,
                                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`ondemand_corr_pyramid_cuda` through the plain versions on any device."""
    return _pyramid("plain", fmap1, f2_levels, coords, radius, out_dtype)
