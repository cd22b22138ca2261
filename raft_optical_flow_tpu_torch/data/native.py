"""ctypes bindings for the port's native data library (`native/*.cpp`).

Counterpart of `raft_optical_flow_tpu/data/native.py`, with a build of its
own: the sources `native/flowdata.cpp` (the .flo, PPM and PFM decoders, the
port's copy), `native/png.cpp` (the PNG row un-filter) and `native/jpeg.cpp`
(the JPEG decoder: Huffman and arithmetic, sequential, progressive and
lossless) are compiled on first use by

    g++ -O3 -shared -fPIC -std=c++17 -o _build/libflowdata_<hash>.so \\
        native/flowdata.cpp native/png.cpp native/jpeg.cpp -lpthread

into `raft_optical_flow_tpu_torch/_build/` (git-ignored), the file name
keyed by a hash of the flags and sources, as `kernels/_build.py` keys the
CUDA library; nothing is written into `native/`. No `-march=native`: the
library does not depend on the host that built it. A failed build raises;
there is no silent fallback. `frame_utils.py` keeps numpy decoders beside
these as their plain versions (the tests' oracles).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("flowdata.cpp", "png.cpp", "jpeg.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libflowdata_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if no library for their hash exists; return its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES),
           "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_char_pp = ctypes.POINTER(ctypes.c_char_p)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        I32, I64 = ctypes.c_int32, ctypes.c_int64
        for name, args in (
            ("flo_dims", [ctypes.c_char_p, i32p, i32p]),
            ("flo_read", [ctypes.c_char_p, f32p, I64]),
            ("flo_read_batch", [c_char_pp, I32, f32p, I64, I32]),
            ("ppm_dims", [ctypes.c_char_p, i32p, i32p]),
            ("ppm_read", [ctypes.c_char_p, u8p, I64]),
            ("pfm_dims", [ctypes.c_char_p, i32p, i32p, i32p]),
            ("pfm_read", [ctypes.c_char_p, f32p, I64]),
            ("png_unfilter", [u8p, I64, I64, I32]),
            ("jpeg_decode", [u8p, I64, u8p, I64, i32p, ctypes.c_char_p, I32]),
            ("jpeg_idct_blocks", [i16p, u16p, I64, u8p]),
            ("jpeg_upsample", [u8p, I32, I32, I32, I32, u8p]),
            ("jpeg_ycc_rgb", [u8p, u8p, u8p, I64, u8p]),
            ("jpeg_ycck_cmyk", [u8p, u8p, u8p, u8p, I64, u8p]),
            ("jpeg_smooth_blocks", [i16p, i32p, u16p, i32p, I64, i16p]),
            ("jpeg_undifference_row", [i32p, u16p, I32, I32, I32, u16p]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_flow_native(path: str) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32."""
    lib = get_lib()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.flo_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError(f"{path}: invalid .flo file")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.flo_read(path.encode(), _ptr(out, ctypes.c_float), out.size)
    if rc != 0:
        raise ValueError(f"{path}: .flo read failed ({rc})")
    return out


def read_flow_batch_native(paths: List[str], num_threads: int = 4) -> np.ndarray:
    """Decode same-size .flo files in parallel -> [N, H, W, 2]."""
    lib = get_lib()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.flo_dims(paths[0].encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError(f"{paths[0]}: invalid .flo file")
    n = len(paths)
    out = np.empty((n, h.value, w.value, 2), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.flo_read_batch(arr, n, _ptr(out, ctypes.c_float), out[0].size, num_threads)
    if rc != 0:
        raise ValueError(f".flo batch read failed ({rc})")
    return out


def read_ppm_native(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255) -> [H, W, 3] uint8."""
    lib = get_lib()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.ppm_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError(f"{path}: invalid PPM file")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.ppm_read(path.encode(), _ptr(out, ctypes.c_uint8), out.size)
    if rc != 0:
        raise ValueError(f"{path}: PPM read failed ({rc})")
    return out


def read_pfm_native(path: str) -> np.ndarray:
    """PFM -> [H, W] or [H, W, 3] float32, top-down."""
    lib = get_lib()
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.pfm_dims(path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)) != 0:
        raise ValueError(f"{path}: invalid PFM file")
    shape = (h.value, w.value, 3) if c.value == 3 else (h.value, w.value)
    out = np.empty(shape, np.float32)
    rc = lib.pfm_read(path.encode(), _ptr(out, ctypes.c_float), out.size)
    if rc != 0:
        raise ValueError(f"{path}: PFM read failed ({rc})")
    return out


def png_unfilter_native(rows: np.ndarray, height: int, row_bytes: int, bpp: int) -> None:
    """Undo PNG's row filters in place: `rows` is the inflated image data,
    uint8, C-contiguous, height x (1 + row_bytes) (each row's filter-type
    byte, then its bytes); bpp is the bytes per pixel (1 for depths below 8)."""
    if rows.dtype != np.uint8 or not rows.flags.c_contiguous or not rows.flags.writeable:
        raise ValueError("png_unfilter_native needs a writable C-contiguous uint8 array")
    if rows.size < height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, {height * (row_bytes + 1)} needed")
    rc = get_lib().png_unfilter(_ptr(rows, ctypes.c_uint8), height, row_bytes, bpp)
    if rc != 0:
        raise ValueError(f"PNG un-filter failed ({rc}: unknown filter type or bpp {bpp})")


def jpeg_decode_native(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] (YCbCr or RGB), [H, W] (grey) or [H, W, 4]
    (CMYK and YCCK, inverted as PIL reads Adobe CMYK) uint8. Raises NotImplementedError for
    a coding the decoder does not take (naming it) and ValueError for a
    truncated or corrupt stream."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8)
    dims = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = lib.jpeg_decode(_ptr(src, ctypes.c_uint8), src.size, None, 0,
                         _ptr(dims, ctypes.c_int32), err, len(err))
    if rc == 0:
        h, w, c = (int(v) for v in dims)
        out = np.empty((h, w, c), np.uint8)
        rc = lib.jpeg_decode(_ptr(src, ctypes.c_uint8), src.size, _ptr(out, ctypes.c_uint8),
                             out.size, _ptr(dims, ctypes.c_int32), err, len(err))
    msg = err.value.decode(errors="replace")
    if rc == 1:
        raise NotImplementedError(f"JPEG: {msg}")
    if rc != 0:
        raise ValueError(f"JPEG: {msg}")
    return out[..., 0] if c == 1 else out


def jpeg_idct_native(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[N, 64] int16 coefficients (natural order) and a [64] quantization
    table -> [N, 8, 8] uint8 samples (the decoder's dequantize and IDCT)."""
    coef = np.ascontiguousarray(coef, np.int16).reshape(-1, 64)
    q = np.ascontiguousarray(qtable, np.uint16).reshape(64)
    out = np.empty((coef.shape[0], 8, 8), np.uint8)
    get_lib().jpeg_idct_blocks(_ptr(coef, ctypes.c_int16), _ptr(q, ctypes.c_uint16),
                               coef.shape[0], _ptr(out, ctypes.c_uint8))
    return out


def jpeg_upsample_native(plane: np.ndarray, hexp: int, vexp: int) -> np.ndarray:
    """One [h, w] uint8 plane upsampled by (hexp, vexp) as the decoder does
    it -> [h * vexp, w * hexp] uint8."""
    plane = np.ascontiguousarray(plane, np.uint8)
    h, w = plane.shape
    out = np.empty((h * vexp, w * hexp), np.uint8)
    if get_lib().jpeg_upsample(_ptr(plane, ctypes.c_uint8), h, w, hexp, vexp,
                               _ptr(out, ctypes.c_uint8)) != 0:
        raise ValueError(f"bad upsampling arguments {plane.shape} x ({hexp}, {vexp})")
    return out


def jpeg_ycc_rgb_native(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Same-shape uint8 Y, Cb, Cr -> [..., 3] uint8 RGB (the decoder's colour
    conversion)."""
    planes = [np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr)]
    if not planes[0].shape == planes[1].shape == planes[2].shape:
        raise ValueError("Y, Cb and Cr differ in shape")
    out = np.empty((*planes[0].shape, 3), np.uint8)
    get_lib().jpeg_ycc_rgb(*(_ptr(p, ctypes.c_uint8) for p in planes), planes[0].size,
                           _ptr(out, ctypes.c_uint8))
    return out


def jpeg_ycck_cmyk_native(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                          k: np.ndarray) -> np.ndarray:
    """Same-shape uint8 Y, Cb, Cr, K -> [..., 4] uint8 CMYK (the decoder's
    YCCK conversion, before PIL's inversion)."""
    planes = [np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr, k)]
    if len({p.shape for p in planes}) != 1:
        raise ValueError("Y, Cb, Cr and K differ in shape")
    out = np.empty((*planes[0].shape, 4), np.uint8)
    get_lib().jpeg_ycck_cmyk(*(_ptr(p, ctypes.c_uint8) for p in planes), planes[0].size,
                             _ptr(out, ctypes.c_uint8))
    return out


def jpeg_smooth_native(coef: np.ndarray, dc: np.ndarray, qtable: np.ndarray,
                       coef_bits: np.ndarray) -> np.ndarray:
    """libjpeg's block-smoothing estimate of each block: [N, 64] int16
    coefficients (natural order), [N, 25] the 5x5 DC values around each
    (row by row, its own at 12), a [64] quantization table and coef_bits of
    coefficients 0-9 -> [N, 64] int16."""
    coef = np.ascontiguousarray(coef, np.int16).reshape(-1, 64)
    dcs = np.ascontiguousarray(dc, np.int32).reshape(-1, 25)
    q = np.ascontiguousarray(qtable, np.uint16).reshape(64)
    bits = np.ascontiguousarray(coef_bits, np.int32).reshape(10)
    if dcs.shape[0] != coef.shape[0]:
        raise ValueError(f"{coef.shape[0]} blocks but {dcs.shape[0]} DC windows")
    out = np.empty_like(coef)
    get_lib().jpeg_smooth_blocks(_ptr(coef, ctypes.c_int16), _ptr(dcs, ctypes.c_int32),
                                 _ptr(q, ctypes.c_uint16), _ptr(bits, ctypes.c_int32),
                                 coef.shape[0], _ptr(out, ctypes.c_int16))
    return out


def jpeg_undifference_native(diff: np.ndarray, prev: Optional[np.ndarray], psv: int,
                             precision: int = 8, pt: int = 0) -> np.ndarray:
    """One row of lossless differences -> its samples (uint16, before the
    point transform's scaling): predictor psv on the row above `prev`, or,
    with prev None, the first row's 1-D prediction from 2**(precision - pt - 1)."""
    d = np.ascontiguousarray(diff, np.int32).reshape(-1)
    out = np.empty(d.size, np.uint16)
    p = None if prev is None else np.ascontiguousarray(prev, np.uint16).reshape(-1)
    if p is not None and p.size != d.size:
        raise ValueError(f"row of {d.size} samples, row above of {p.size}")
    rc = get_lib().jpeg_undifference_row(
        _ptr(d, ctypes.c_int32), None if p is None else _ptr(p, ctypes.c_uint16), d.size, psv,
        1 << (precision - pt - 1), _ptr(out, ctypes.c_uint16))
    if rc != 0:
        raise ValueError(f"bad row ({d.size} samples) or predictor {psv}")
    return out
