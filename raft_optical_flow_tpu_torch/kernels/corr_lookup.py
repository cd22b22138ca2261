"""Windowed bilinear lookup over a materialized correlation pyramid.

Counterpart of `raft_optical_flow_tpu/kernels/corr_lookup.py`. Two CUDA
kernels (`csrc/corr_lookup.cu`, built by `_build.py`, bound through ctypes):

  - K1 `corr_lookup_level`: one pyramid level (replaces `_lookup_level_kernel`);
  - K2 `corr_lookup_coarse_fused`: levels 1..L-1 in one launch (replaces
    `_coarse_fused_kernel`); empty levels come out as zeros.

`corr_pyramid_lookup_cuda` has the signature of the JAX package's
`corr_pyramid_lookup_pallas`. For a CUDA tensor each wrapper launches its
kernel or raises; for a CPU tensor it runs the plain version
(`ops/corr.py::sample_corr_window`), which is also the kernels' oracle. Each
wrapper counts its launches in `LAUNCHES`. Forward only: the volume gradient
(K3) comes with training.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from raft_optical_flow_tpu_torch.kernels import _build
from raft_optical_flow_tpu_torch.ops.corr import sample_corr_window

# launches of each kernel since the last reset_launches(); plain runs do not count
LAUNCHES: Dict[str, int] = {"corr_lookup_level": 0, "corr_lookup_coarse_fused": 0}

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


def corr_lookup_coarse_fused_plain(levels, coords, radius, out_dtype=torch.float32):
    """Plain version of K2: levels 1..L-1, level-0 [B, Q, 2] -> [B, Q, (L-1)*K^2]."""
    outs = [
        sample_corr_window(c, coords[..., 0] * (1.0 / 2**lvl),
                           coords[..., 1] * (1.0 / 2**lvl), radius)
        for lvl, c in enumerate(levels, start=1)
    ]
    return torch.cat(outs, dim=-1).to(out_dtype)


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


def corr_pyramid_lookup_cuda(
    pyramid: Sequence[torch.Tensor],
    coords: torch.Tensor,
    radius: int,
    out_dtype: torch.dtype = torch.float32,
    fuse_coarse: bool = False,
) -> torch.Tensor:
    """Multi-level lookup through K1 (and K2 when `fuse_coarse`).

    pyramid: [B, Q, Hl, Wl] per level, level 0 first; coords: [B, h, w, 2]
    level-0 (x, y), Q = h*w. fuse_coarse (the serving path) runs levels
    1..L-1 through one K2 launch when there are more than two levels.
    Returns [B, h, w, L*(2r+1)^2] out_dtype, levels concatenated coarse-last.
    """
    B, h, w, _ = coords.shape
    flat = coords.reshape(B, h * w, 2).float().contiguous()
    outs = [corr_lookup_level(pyramid[0], flat, radius, out_dtype)]
    if fuse_coarse and len(pyramid) > 2:
        outs.append(corr_lookup_coarse_fused(pyramid[1:], flat, radius, out_dtype))
    else:
        for lvl, c in enumerate(pyramid[1:], start=1):
            outs.append(corr_lookup_level(c, flat * (1.0 / 2**lvl), radius, out_dtype))
    return torch.cat(outs, dim=-1).reshape(B, h, w, -1)
