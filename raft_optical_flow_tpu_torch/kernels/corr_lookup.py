"""Windowed bilinear lookup over a materialized correlation pyramid.

Counterpart of `raft_optical_flow_tpu/kernels/corr_lookup.py`. Three CUDA
kernels (`csrc/corr_lookup.cu`, built by `_build.py`, bound through ctypes):

  - K1 `corr_lookup_level`: one pyramid level (replaces `_lookup_level_kernel`);
  - K2 `corr_lookup_coarse_fused`: levels 1..L-1 in one launch (replaces
    `_coarse_fused_kernel`); empty levels come out as zeros; forward only;
  - K3 `corr_lookup_level_bwd`: K1's gradient wrt the volume (replaces
    `_lookup_level_bwd_kernel`), the backward of the autograd Function
    `LookupLevel`, whose forward is K1;
  - K8 `corr_lookup_all_levels`: every level in one launch, fp32 output
    (replaces `_fused_lookup_kernel`, through `corr_pyramid_lookup_cuda_fused`,
    the counterpart of `corr_pyramid_lookup_pallas_fused`); K2's device code
    from level 0. No model path calls it, in the JAX package as here.

`corr_pyramid_lookup_cuda` has the signature of the JAX package's
`corr_pyramid_lookup_pallas`. For a CUDA tensor each wrapper launches its
kernel or raises; for a CPU tensor it runs the plain version (K1, K2:
`ops/corr.py::sample_corr_window`; K3: `corr_lookup_level_bwd_plain`; K8:
`corr_pyramid_lookup_fused_plain`), which
is also the kernel's oracle. Each wrapper counts its launches in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from raft_optical_flow_tpu_torch.kernels import _build
from raft_optical_flow_tpu_torch.ops.corr import sample_corr_window

# launches of each kernel since the last reset_launches(); plain runs do not count
LAUNCHES: Dict[str, int] = {
    "corr_lookup_level": 0, "corr_lookup_coarse_fused": 0, "corr_lookup_level_bwd": 0,
    "corr_lookup_all_levels": 0,
}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_COARSE_LEVELS = 8
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.raft_corr_lookup_level.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
        lib.raft_corr_lookup_level.restype = I
        lib.raft_corr_lookup_coarse_fused.argtypes = [P, P, P, P, I, P, P, I, I, I, I, I, P]
        lib.raft_corr_lookup_coarse_fused.restype = I
        lib.raft_corr_lookup_level_bwd.argtypes = [P, P, P, I, I, I, I, I, I, I, P]
        lib.raft_corr_lookup_level_bwd.restype = I
        lib.raft_corr_lookup_all_levels.argtypes = [P, P, P, I, P, P, I, I, I, I, P]
        lib.raft_corr_lookup_all_levels.restype = I
        _lib = lib
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _check_volume(corr: torch.Tensor, B: int, Q: int, device: torch.device) -> None:
    if corr.dim() != 4 or corr.shape[:2] != (B, Q):
        raise ValueError(f"volume must be [B={B}, Q={Q}, Hl, Wl], got {tuple(corr.shape)}")
    if corr.dtype not in _DTYPE_CODE:
        raise TypeError(f"volume dtype must be float32 or bfloat16, got {corr.dtype}")
    if corr.device != device:
        raise ValueError(f"volume on {corr.device}, coords on {device}")
    if not corr.is_contiguous():
        raise ValueError("volume must be contiguous")


def _check_coords(coords: torch.Tensor, out_dtype: torch.dtype, radius: int) -> None:
    if coords.dim() != 3 or coords.shape[2] != 2 or coords.dtype != torch.float32:
        raise ValueError(f"coords must be float32 [B, Q, 2], got {coords.dtype} {tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")


def corr_lookup_level_plain(corr_l, coords_l, radius, out_dtype=torch.float32):
    """Plain version of K1: [B, Q, Hl, Wl], level-scaled [B, Q, 2] -> [B, Q, K^2]."""
    return sample_corr_window(corr_l, coords_l[..., 0], coords_l[..., 1], radius).to(out_dtype)


def _levels_plain(levels, coords, radius, start):
    """sample_corr_window at pyramid levels start, start+1, ... with level-0
    coords [B, Q, 2] scaled by 1/2^l, concatenated: [B, Q, len(levels)*K^2]."""
    outs = [
        sample_corr_window(c, coords[..., 0] * (1.0 / 2**lvl),
                           coords[..., 1] * (1.0 / 2**lvl), radius)
        for lvl, c in enumerate(levels, start=start)
    ]
    return torch.cat(outs, dim=-1)


def corr_lookup_coarse_fused_plain(levels, coords, radius, out_dtype=torch.float32):
    """Plain version of K2: levels 1..L-1, level-0 [B, Q, 2] -> [B, Q, (L-1)*K^2]."""
    return _levels_plain(levels, coords, radius, start=1).to(out_dtype)


def corr_pyramid_lookup_fused_plain(pyramid, coords, radius):
    """Plain version of K8: every level, level-0 coords [B, h, w, 2] ->
    fp32 [B, h, w, L*K^2] (`ops/corr.py::corr_pyramid_lookup`, then `.float()`)."""
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).float()
    return _levels_plain(pyramid, flat, radius, start=0).float().reshape(B, h, w, -1)


def corr_lookup_level(corr_l: torch.Tensor, coords_l: torch.Tensor, radius: int,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1: window lookup at one level.

    corr_l: [B, Q, Hl, Wl] fp32 or bf16, contiguous; coords_l: [B, Q, 2] fp32
    (x, y) already scaled to the level. Returns [B, Q, (2r+1)^2] out_dtype.
    An empty level returns zeros without a launch.
    """
    _check_coords(coords_l, out_dtype, radius)
    B, Q, _ = coords_l.shape
    _check_volume(corr_l, B, Q, coords_l.device)
    if not corr_l.is_cuda:
        return corr_lookup_level_plain(corr_l, coords_l, radius, out_dtype)
    Hl, Wl = corr_l.shape[2:]
    K = 2 * radius + 1
    if Hl == 0 or Wl == 0 or B * Q == 0:
        return torch.zeros(B, Q, K * K, dtype=out_dtype, device=corr_l.device)
    out = torch.empty(B, Q, K * K, dtype=out_dtype, device=corr_l.device)
    lib = _kernels()
    with torch.cuda.device(corr_l.device):
        err = lib.raft_corr_lookup_level(
            corr_l.data_ptr(), coords_l.data_ptr(), out.data_ptr(), B, Q, Hl, Wl,
            radius, _DTYPE_CODE[corr_l.dtype], _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_lookup_level")
    LAUNCHES["corr_lookup_level"] += 1
    return out


def corr_lookup_coarse_fused(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                             radius: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: window lookup at pyramid levels 1..L-1 in one launch.

    levels: [B, Q, Hl, Wl] volumes of levels 1, 2, ... (one dtype, contiguous;
    empty levels allowed); coords: [B, Q, 2] fp32 level-0 (x, y), scaled by
    1/2^l inside. Returns [B, Q, len(levels)*(2r+1)^2] out_dtype, the levels'
    windows concatenated in order, zeros for empty levels.
    """
    _check_coords(coords, out_dtype, radius)
    B, Q, _ = coords.shape
    if not 1 <= len(levels) <= MAX_COARSE_LEVELS:
        raise ValueError(f"1..{MAX_COARSE_LEVELS} coarse levels, got {len(levels)}")
    for c in levels:
        _check_volume(c, B, Q, coords.device)
    if len({c.dtype for c in levels}) != 1:
        raise TypeError("coarse levels must share one dtype")
    if not coords.is_cuda:
        return corr_lookup_coarse_fused_plain(levels, coords, radius, out_dtype)
    n = len(levels)
    K = 2 * radius + 1
    out = torch.empty(B, Q, n * K * K, dtype=out_dtype, device=coords.device)
    if B * Q == 0:
        return out
    ptrs = (ctypes.c_void_p * n)(*[c.data_ptr() for c in levels])
    hs = (ctypes.c_int * n)(*[c.shape[2] for c in levels])
    ws = (ctypes.c_int * n)(*[c.shape[3] for c in levels])
    lvl = (ctypes.c_int * n)(*range(1, n + 1))
    lib = _kernels()
    with torch.cuda.device(coords.device):
        err = lib.raft_corr_lookup_coarse_fused(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
            ctypes.addressof(lvl), n, coords.data_ptr(), out.data_ptr(), B, Q, radius,
            _DTYPE_CODE[levels[0].dtype], _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_lookup_coarse_fused")
    LAUNCHES["corr_lookup_coarse_fused"] += 1
    return out


def _tap_weights(c: torch.Tensor, radius: int, n: int) -> torch.Tensor:
    """[B, Q, K, n]: the weight K1 gives pixel p of an n-pixel axis in window
    column a, for level-scaled centres c [B, Q]. K1's arithmetic: pa = c + a - r,
    p0 = floor(pa), weight 1 - (pa - p0) at p0 and pa - p0 at p0 + 1 (the tri
    selector tri(p - pa), rounded as K1 rounds it)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=c.device)
    pa = c[..., None] + d
    p0 = torch.floor(pa)
    wa = (pa - p0)[..., None]
    pi = p0.clamp(-2, n).long()[..., None]  # clamp in float before the int cast
    p = torch.arange(n, device=c.device)
    zero = torch.zeros((), device=c.device)
    return torch.where(pi == p, 1 - wa, zero) + torch.where(pi + 1 == p, wa, zero)


def corr_lookup_level_bwd_plain(coords_l, g, Hl, Wl, radius, out_dtype=torch.float32):
    """Plain version of K3: level-scaled coords [B, Q, 2], g [B, Q, K^2] ->
    dcorr [B, Q, Hl, Wl] out_dtype. The separable form: selectors X [B, Q, K, Wl]
    and Y [B, Q, K, Hl], two fp32 einsums, one cast."""
    B, Q, _ = coords_l.shape
    K = 2 * radius + 1
    X = _tap_weights(coords_l[..., 0], radius, Wl)
    Y = _tap_weights(coords_l[..., 1], radius, Hl)
    g3 = g.float().reshape(B, Q, K, K)  # [.., a, b]: channel k = a*K + b
    t = torch.einsum("nqab,nqbh->nqah", g3, Y)
    return torch.einsum("nqah,nqaw->nqhw", t, X).to(out_dtype)


def corr_lookup_level_bwd(coords_l: torch.Tensor, g: torch.Tensor, Hl: int, Wl: int,
                          radius: int, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K3: K1's gradient wrt the volume at one level.

    coords_l: [B, Q, 2] fp32 level-scaled (x, y), contiguous; g: [B, Q, (2r+1)^2]
    fp32 or bf16, contiguous (K1's output cotangent); out_dtype: the volume's
    dtype. Returns dense dcorr [B, Q, Hl, Wl] out_dtype (fp32 sums, one
    rounding). An empty level returns an empty tensor without a launch.
    """
    _check_coords(coords_l, out_dtype, radius)
    B, Q, _ = coords_l.shape
    K = 2 * radius + 1
    if tuple(g.shape) != (B, Q, K * K) or g.dtype not in _DTYPE_CODE:
        raise ValueError(f"g must be float32/bfloat16 [{B}, {Q}, {K * K}], "
                         f"got {g.dtype} {tuple(g.shape)}")
    if g.device != coords_l.device or not g.is_contiguous():
        raise ValueError("g must be contiguous and on the coords' device")
    if Hl < 0 or Wl < 0:
        raise ValueError(f"level shape must be >= 0, got {Hl}x{Wl}")
    if not coords_l.is_cuda:
        return corr_lookup_level_bwd_plain(coords_l, g, Hl, Wl, radius, out_dtype)
    out = torch.empty(B, Q, Hl, Wl, dtype=out_dtype, device=coords_l.device)
    if out.numel() == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(coords_l.device):
        err = lib.raft_corr_lookup_level_bwd(
            coords_l.data_ptr(), g.data_ptr(), out.data_ptr(), B, Q, Hl, Wl, radius,
            _DTYPE_CODE[g.dtype], _DTYPE_CODE[out_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_lookup_level_bwd")
    LAUNCHES["corr_lookup_level_bwd"] += 1
    return out


class LookupLevel(torch.autograd.Function):
    """K1 with K3 as its backward: differentiable wrt the volume only.

    apply(corr_l, coords_l, radius, out_dtype) -> [B, Q, (2r+1)^2]. The coords
    gradient is None, as the JAX package's `_lookup_level_bwd` returns zeros:
    RAFT detaches coords before every lookup.
    """

    @staticmethod
    def forward(ctx, corr_l, coords_l, radius, out_dtype):
        ctx.save_for_backward(coords_l)
        ctx.radius = radius
        ctx.level_shape = tuple(corr_l.shape[2:])
        ctx.volume_dtype = corr_l.dtype
        return corr_lookup_level(corr_l, coords_l, radius, out_dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (coords_l,) = ctx.saved_tensors
        dcorr = corr_lookup_level_bwd(coords_l, g.contiguous(), *ctx.level_shape,
                                      ctx.radius, ctx.volume_dtype)
        return dcorr, None, None, None


def corr_pyramid_lookup_cuda(
    pyramid: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
    out_dtype: torch.dtype = torch.float32,
    fuse_coarse: bool = False,
) -> torch.Tensor:
    """Multi-level lookup through K1 (and K2 when `fuse_coarse`).

    pyramid: [B, Q, Hl, Wl] per level, level 0 first; coords: [B, h, w, 2]
    level-0 (x, y), Q = h*w. fuse_coarse (the serving path, forward only) runs
    levels 1..L-1 through one K2 launch when there are more than two levels.
    Every per-level lookup goes through `LookupLevel`, so under autograd the
    volume gradient of each level is one K3 launch (training).
    Returns [B, h, w, L*(2r+1)^2] out_dtype, levels concatenated coarse-last.
    """
    B, h, w, _ = coords.shape
    if fuse_coarse and torch.is_grad_enabled() and any(c.requires_grad for c in pyramid):
        raise ValueError("fuse_coarse is forward only (K2 has no backward); "
                         "run the lookup per level to differentiate it")
    flat = coords.reshape(B, h * w, 2).float().contiguous()
    outs = [LookupLevel.apply(pyramid[0], flat, radius, out_dtype)]
    if fuse_coarse and len(pyramid) > 2:
        outs.append(corr_lookup_coarse_fused(pyramid[1:], flat, radius, out_dtype))
    else:
        for lvl, c in enumerate(pyramid[1:], start=1):
            outs.append(LookupLevel.apply(c, flat * (1.0 / 2**lvl), radius, out_dtype))
    return torch.cat(outs, dim=-1).reshape(B, h, w, -1)


def corr_pyramid_lookup_cuda_fused(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                                   radius: int) -> torch.Tensor:
    """K8: window lookup at every pyramid level in one launch, forward only.

    Counterpart of the JAX package's `corr_pyramid_lookup_pallas_fused`.
    pyramid: [B, Q, Hl, Wl] per level, level 0 first (one dtype, fp32 or bf16,
    contiguous; empty levels allowed); coords: [B, h, w, 2] level-0 (x, y),
    Q = h*w. Returns fp32 [B, h, w, L*(2r+1)^2] whatever the volume dtype,
    levels in order, zeros for empty levels.
    """
    if coords.dim() != 4 or coords.shape[3] != 2:
        raise ValueError(f"coords must be [B, h, w, 2], got {tuple(coords.shape)}")
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).float().contiguous()
    _check_coords(flat, torch.float32, radius)
    if not 1 <= len(pyramid) <= MAX_COARSE_LEVELS:
        raise ValueError(f"1..{MAX_COARSE_LEVELS} levels, got {len(pyramid)}")
    for c in pyramid:
        _check_volume(c, B, h * w, coords.device)
    if len({c.dtype for c in pyramid}) != 1:
        raise TypeError("pyramid levels must share one dtype")
    if not coords.is_cuda:
        return corr_pyramid_lookup_fused_plain(pyramid, coords, radius)
    n = len(pyramid)
    K = 2 * radius + 1
    out = torch.empty(B, h * w, n * K * K, dtype=torch.float32, device=coords.device)
    if B * h * w == 0:
        return out.reshape(B, h, w, -1)
    ptrs = (ctypes.c_void_p * n)(*[c.data_ptr() for c in pyramid])
    hs = (ctypes.c_int * n)(*[c.shape[2] for c in pyramid])
    ws = (ctypes.c_int * n)(*[c.shape[3] for c in pyramid])
    lib = _kernels()
    with torch.cuda.device(coords.device):
        err = lib.raft_corr_lookup_all_levels(
            ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws), n,
            flat.data_ptr(), out.data_ptr(), B, h * w, radius,
            _DTYPE_CODE[pyramid[0].dtype], torch.cuda.current_stream().cuda_stream,
        )
    _check(err, "corr_lookup_all_levels")
    LAUNCHES["corr_lookup_all_levels"] += 1
    return out.reshape(B, h, w, -1)
