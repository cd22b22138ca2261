"""The three OpenCV image operations the augmentors and the HSV flow
visualization use, rebuilt in numpy to OpenCV's own rounding (no cv2 on the
card's machine):

  - `resize_linear`: `cv2.resize(img, None, fx, fy, interpolation=INTER_LINEAR)`;
  - `rgb_to_hsv_u8`: `cv2.cvtColor(img, COLOR_RGB2HSV)` on uint8;
  - `hsv_to_rgb_u8`: `cv2.cvtColor(img, COLOR_HSV2RGB)` on uint8.

Each follows OpenCV's code, not the textbook formula, which misses it on
about a seventh of uint8 resize outputs and three quarters of HSV triples:

  resize: the output is round(w*fx) x round(h*fy) (half to even). Output
  pixel d samples source position (d + 0.5) / f - 0.5, computed in double
  and rounded to float32 before the floor; its weights are float32 (1 - t, t).
  Columns left of the first source pixel or right of the last take that
  pixel (weight 0 on its neighbour); rows clamp their indices instead. The
  horizontal pass runs first, then the vertical one. uint8 runs in fixed
  point: weights round(w * 2048), the horizontal pass exact in int32, the
  vertical pass as OpenCV's SIMD code rounds it,
  ((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2. float32
  multiplies and adds in float32. Equal to cv2 5.0's output for uint8 at
  any channel count and for float32 at 2 channels (flows). For float32 at
  1, 3 or 4 channels cv2 5.0 takes another route (Intel IPP), which places
  the samples in double precision; so does this function there, within
  about 1e-7 of cv2's output relative to its largest magnitude.
  A resize whose output has the input's size is a copy, as in cv2.

  RGB -> HSV: fixed point with hsv_shift 12, sdiv[i] = round((255 << 12) / i),
  hdiv[i] = round((180 << 12) / (6 i)); hue in [0, 180).

  HSV -> RGB: float32, s and v scaled by fl(1/255), h by fl(6/180); the
  sector table of OpenCV's HSV2RGB; the two products 1 - s*f and
  1 - s*(1 - f) fused (one rounding, as the compiler contracts them in cv2's
  AVX2 build); each channel's value * 255 to uint8. cv2 converts each image
  row in blocks of 32 pixels with vector code, which truncates, and the
  row's last W mod 32 pixels with scalar code, which rounds to nearest; so
  does this function (`HSV2RGB_SIMD_BLOCK`: the AVX2 build's 4 vectors of 8
  float lanes).

Both HSV conversions equal cv2 on every input (2^24 RGB colours, 180 x 256 x
256 HSV triples, HSV in both of cv2's code paths; the tests run them all).
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32
HSV2RGB_SIMD_BLOCK = 32
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE
_HSV_SHIFT = 12


def _axis(n_out: int, scale: float, pos_dtype):
    """The source index i0 and weight t (float32) of each output position
    along one axis: it reads (1 - t) x[i0] + t x[i0 + 1]."""
    pos = ((np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5).astype(pos_dtype)
    i0 = np.floor(pos).astype(np.int64)
    t = (pos - i0).astype(_F32)
    return i0, t


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """`cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)`
    for uint8 or float32 [H, W] or [H, W, C] images."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_linear takes uint8 or float32, not {img.dtype}")
    h, w = img.shape[:2]
    dh, dw = int(round(h * fy)), int(round(w * fx))
    if dh < 1 or dw < 1:
        raise ValueError(f"resize of {h}x{w} by ({fx}, {fy}) is empty")
    if (dh, dw) == (h, w):  # cv2 copies a same-size resize, whatever fx and fy are
        return img.copy()
    x = img if img.ndim == 3 else img[..., None]
    pos_dtype = _F32 if img.dtype == np.uint8 or x.shape[2] == 2 else np.float64
    sx, ax = _axis(dw, fx, pos_dtype)
    sy, ay = _axis(dh, fy, pos_dtype)
    left, right = sx < 0, sx >= w - 1
    ax[left | right] = 0
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    a0, b0 = _F32(1) - ax, _F32(1) - ay
    if img.dtype == np.uint8:
        ia0, ia1, ib0, ib1 = (np.rint(v * _F32(_COEF_SCALE)).astype(np.int32)
                              for v in (a0, ax, b0, ay))
        xi = x.astype(np.int32)
        rows = xi[:, sx] * ia0[:, None] + xi[:, sx1] * ia1[:, None]
        out = (((rows[y0] >> 4) * ib0[:, None, None]) >> 16) \
            + (((rows[y1] >> 4) * ib1[:, None, None]) >> 16)
        out = np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    else:
        rows = x[:, sx] * a0[:, None] + x[:, sx1] * ax[:, None]
        out = rows[y0] * b0[:, None, None] + rows[y1] * ay[:, None, None]
    return out if img.ndim == 3 else out[..., 0]


def _div_table(num: int, den: float) -> np.ndarray:
    i = np.arange(256, dtype=np.float64)
    return np.where(i > 0, np.rint(num / (den * np.maximum(i, 1))), 0).astype(np.int64)


_SDIV = _div_table(255 << _HSV_SHIFT, 1.0)
_HDIV = _div_table(180 << _HSV_SHIFT, 6.0)
# OpenCV's HSV2RGB sector table: for each sector, the tab entries of (b, g, r)
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_RGB2HSV)` for uint8 [..., 3] RGB."""
    x = np.asarray(img).astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _one_minus_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """fl32(1 - a*b) with one rounding (a fused multiply-add): the float32
    product is exact in float64."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(_F32)


def hsv_to_rgb_u8(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, cv2.COLOR_HSV2RGB)` for uint8 [..., W, 3] HSV, hue
    in [0, 180), rows along axis -2."""
    x = np.asarray(img)
    h = x[..., 0].astype(_F32) * _F32(6.0 / 180.0)
    s = x[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = x[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.floor(h)
    f = h - sector
    tab = np.stack([v, v * (_F32(1) - s), v * _one_minus_product(s, f),
                    v * _one_minus_product(s, _F32(1) - f)], axis=-1)
    rgb = np.take_along_axis(tab, _SECTOR[sector.astype(np.int64) % 6], axis=-1)[..., ::-1]
    rgb = rgb * _F32(255)
    w = x.shape[-2]
    vec = w // HSV2RGB_SIMD_BLOCK * HSV2RGB_SIMD_BLOCK
    out = np.floor(rgb)
    out[..., vec:, :] = np.rint(rgb[..., vec:, :])
    return np.clip(out, 0, 255).astype(np.uint8)
