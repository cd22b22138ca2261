"""Flow and image file codecs without PIL or cv2: Middlebury .flo, .pfm, PPM,
PNG (with KITTI's 16-bit flow PNGs) and JPEG.

Counterpart of `raft_optical_flow_tpu/data/frame_utils.py`. The JAX package
reads PNG and JPEG frames with PIL and KITTI's 3-channel 16-bit PNGs with
cv2; neither is on the card's machine, so both are decoded here.

PNG: the chunks and zlib (stdlib), then the row un-filter in the native
library (`native/png.cpp`), then numpy unpacking; Adam7-interlaced files
un-filter each of the seven passes with its own row width and scatter them
into the frame. Two readers, each following one of the JAX package's:
  - `read_png` follows cv2 (`IMREAD_UNCHANGED`) in keeping every bit: 8-bit
    grey, grey+alpha, RGB and RGBA as uint8, every 16-bit type as uint16,
    1-bit grey as bool, 2- and 4-bit grey scaled to 0-255, palette images as
    their indices (uint8). `read_flow_kitti` and `read_disp_kitti` read the
    16 bits through it, as the JAX package reads them through cv2.
  - `read_gen` follows PIL (`np.array(Image.open(path))`) for frames: the
    same, except that 16-bit RGB, RGBA and grey+alpha come out as uint8,
    the high byte of each sample, as PIL reads them ("RGB;16B"), grey+alpha
    as [H, W, 4] (grey, grey, grey, alpha: PIL opens it as RGBA); 16-bit
    grey stays uint16 (PIL's "I;16").
`write_png` writes 8- and 16-bit RGB, filter 0.

JPEG: `decode_jpeg` and `read_jpeg` go through the native decoder
(`native/jpeg.cpp`): Huffman and arithmetic coding, sequential (SOF0, SOF1,
SOF9), progressive (SOF2, SOF10) and lossless (SOF3); libjpeg's ISLOW IDCT,
its block smoothing of progressive files whose scans leave low
coefficients unrefined, fancy upsampling and YCbCr->RGB, bit for bit with
PIL on libjpeg-turbo. The output is PIL's: [H, W, 3] uint8 for YCbCr and
RGB files, [H, W] for grey, [H, W, 4] for CMYK and YCCK (inverted, as PIL
reads Adobe CMYK). What PIL does not open either raises NotImplementedError
naming it: lossless arithmetic (SOF11), hierarchical files (SOF5-SOF7,
SOF13-SOF15) and precisions other than 8 bits; a truncated or corrupt
stream raises ValueError. The numpy versions of its pixel stages
(`jpeg_idct_plain`, `jpeg_upsample_plain`, `jpeg_ycc_rgb_plain`,
`jpeg_ycck_cmyk_plain`, `jpeg_smooth_plain`, `jpeg_undifference_plain`)
are the tests' oracles for the native ones.

The .flo, PFM and PPM readers and the un-filter go through the native
library (`data/native.py`, built on first use; a failed build raises); the
`*_plain` functions are their numpy versions, the tests' oracles. `read_gen`
returns numpy arrays where the JAX one returns PIL images.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from raft_optical_flow_tpu_torch.data import native

FLO_MAGIC = 202021.25
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's seven passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_PPM_FIELD = re.compile(rb"(?:\s|#[^\n]*\n)*(\d+)")  # whitespace and comments, a number


# -- .flo ----------------------------------------------------------------------


def read_flow(path: str) -> np.ndarray:
    """Read a Middlebury .flo file -> [H, W, 2] float32 (native decoder)."""
    return native.read_flow_native(path)


def read_flow_plain(path: str) -> np.ndarray:
    """numpy version of `read_flow`."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flow(path: str, flow: np.ndarray) -> None:
    """Write [H, W, 2] float32 flow as Middlebury .flo."""
    flow = np.asarray(flow, dtype=np.float32)
    assert flow.ndim == 3 and flow.shape[2] == 2
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([FLO_MAGIC], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.tofile(f)


# -- .pfm ----------------------------------------------------------------------


def read_pfm(path: str) -> np.ndarray:
    """Read a .pfm file -> [H, W] or [H, W, 3] float32, top-down (native)."""
    return native.read_pfm_native(path)


def read_pfm_plain(path: str) -> np.ndarray:
    """numpy version of `read_pfm`."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f4")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape)).astype(np.float32)


# -- PPM -----------------------------------------------------------------------


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, maxval 255) -> [H, W, 3] uint8 (native)."""
    return native.read_ppm_native(path)


def read_ppm_plain(path: str) -> np.ndarray:
    """numpy version of `read_ppm` (header comments allowed)."""
    data = open(path, "rb").read()
    fields, pos = [], 2
    if data[:2] != b"P6":
        raise ValueError(f"{path}: not a binary PPM")
    while len(fields) < 3:
        m = _PPM_FIELD.match(data, pos)
        if m is None:
            raise ValueError(f"{path}: malformed PPM header")
        fields.append(int(m.group(1)))
        pos = m.end()
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval}, only 255 is read")
    pos += 1  # the single whitespace before the raster
    return np.frombuffer(data, np.uint8, 3 * w * h, pos).reshape(h, w, 3).copy()


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] uint8 as binary PPM (P6)."""
    img = np.ascontiguousarray(img, np.uint8)
    assert img.ndim == 3 and img.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


# -- PNG -----------------------------------------------------------------------


def png_unfilter_plain(rows: np.ndarray, height: int, row_bytes: int, bpp: int) -> None:
    """numpy version of the native un-filter (`native/png.cpp`), in place on
    height x (1 + row_bytes) uint8 rows. Sub is a per-lane cumulative sum;
    Average and Paeth loop over the row's pixels."""
    r = rows[: height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        t, x = int(r[y, 0]), r[y, 1:]
        if t == 1:
            n = row_bytes // bpp * bpp
            lanes = x[:n].reshape(-1, bpp)
            lanes[:] = np.cumsum(lanes, axis=0, dtype=np.uint8)
            for i in range(n, row_bytes):  # a partial last pixel (bit depths < 8 have bpp 1)
                x[i] = (int(x[i]) + int(x[i - bpp])) & 255
        elif t == 2:
            x[:] = (x.astype(np.int32) + prev) & 255
        elif t in (3, 4):
            cur = x.astype(np.int32)
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                if t == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 255
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 255
            x[:] = cur
        elif t != 0:
            raise ValueError(f"PNG filter type {t}")
        prev = x.astype(np.int32)


def _png_image(rows: np.ndarray, h: int, w: int, ch: int, depth: int, color: int,
               unfilter) -> np.ndarray:
    """Un-filter one (sub)image's rows in place and unpack them -> [h, w, ch]."""
    row_bytes = (w * ch * depth + 7) // 8
    unfilter(rows, h, row_bytes, max(1, ch * depth // 8))
    px = rows[: h * (row_bytes + 1)].reshape(h, row_bytes + 1)[:, 1:]
    if depth == 16:
        return px.view(">u2").reshape(h, w, ch).astype(np.uint16)
    if depth == 8:
        return px.reshape(h, w, ch)
    # 1, 2, 4 bits: one channel (grey or palette), packed big-endian
    bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)
    out = (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(np.uint8)[:, :w, None]
    if color == 0:  # PIL's "1" is bool; "L;2" and "L;4" scale to 0-255
        out = out.astype(bool) if depth == 1 else out * np.uint8(255 // (2 ** depth - 1))
    return out


def decode_png(data: bytes, unfilter=native.png_unfilter_native) -> np.ndarray:
    """PNG bytes -> numpy array (`read_png`'s types; see the module docstring)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    ch = _PNG_CHANNELS.get(color)
    if ch is None or depth not in {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(color, (8, 16)):
        raise ValueError(f"PNG color type {color}, bit depth {depth}")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace}")
    if not idat:
        raise ValueError("PNG without IDAT")
    rows = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    if not interlace:
        out = _png_image(rows, h, w, ch, depth, color, unfilter)
    else:  # Adam7: each pass is a small image of its own, rows filtered on their own
        out, off = None, 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes, not even filter bytes
            n = ph * ((pw * ch * depth + 7) // 8 + 1)
            part = _png_image(rows[off: off + n], ph, pw, ch, depth, color, unfilter)
            if out is None:
                out = np.zeros((h, w, ch), part.dtype)
            out[y0::dy, x0::dx] = part
            off += n
    out = np.ascontiguousarray(out)
    return out[..., 0] if ch == 1 else out


def read_png(path: str) -> np.ndarray:
    """PNG file -> numpy array, every bit kept (cv2's types; see the module
    docstring); `read_gen` gives PIL's."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 or uint16 RGB -> PNG bytes, filter 0."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG writes [H, W, 3] uint8 or uint16, not {img.shape} {img.dtype}")
    h, w, _ = img.shape
    depth = 8 * img.dtype.itemsize
    raster = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), raster.view(np.uint8)], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, 2, 0, 0, 0)  # color type 2: RGB
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# -- JPEG ----------------------------------------------------------------------


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> what `np.array(PIL.Image.open(...))` gives (native
    decoder; see the module docstring)."""
    return native.jpeg_decode_native(data)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


# jidctint.c's FIX() constants at CONST_BITS = 13
_FIX = {"0_298": 2446, "0_390": 3196, "0_541": 4433, "0_765": 6270, "0_899": 7373,
        "1_175": 9633, "1_501": 12299, "1_847": 15137, "1_961": 16069, "2_053": 16819,
        "2_562": 20995, "3_072": 25172}


def _idct_1d(v: np.ndarray, shift: int) -> np.ndarray:
    """jpeg_idct_islow's 1-D pass on the last axis (int64), descaled by shift."""
    f = _FIX
    z2, z3 = v[..., 2], v[..., 6]
    z1 = (z2 + z3) * f["0_541"]
    tmp2, tmp3 = z1 - z3 * f["1_847"], z1 + z2 * f["0_765"]
    tmp0, tmp1 = (v[..., 0] + v[..., 4]) << 13, (v[..., 0] - v[..., 4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[..., 7], v[..., 5], v[..., 3], v[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175"]
    z3, z4 = z5 - z3 * f["1_961"], z5 - z4 * f["0_390"]
    z1, z2 = -z1 * f["0_899"], -z2 * f["2_562"]
    t0 = t0 * f["0_298"] + z1 + z3
    t1 = t1 * f["2_053"] + z2 + z4
    t2 = t2 * f["3_072"] + z2 + z3
    t3 = t3 * f["1_501"] + z1 + z4
    out = (t10 + t3, t11 + t2, t12 + t1, t13 + t0, t13 - t0, t12 - t1, t11 - t2, t10 - t3)
    return (np.stack(out, -1) + (1 << (shift - 1))) >> shift


def jpeg_idct_plain(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """numpy version of the native dequantize and IDCT (libjpeg's
    jpeg_idct_islow; its zero-column and zero-row short cuts give the same
    values and are left out): [N, 64] int16 coefficients in natural order and
    a [64] table -> [N, 8, 8] uint8, each centred sample x mapped through
    the range-limit table at x & 1023 (clamped near range, wrapped far out)."""
    deq = np.asarray(coef, np.int64).reshape(-1, 8, 8) * np.asarray(qtable, np.int64).reshape(8, 8)
    ws = _idct_1d(deq.transpose(0, 2, 1), 11).transpose(0, 2, 1)  # columns, PASS1_BITS kept
    x = _idct_1d(ws, 18) & 1023  # rows; CONST_BITS + PASS1_BITS + 3
    return np.where(x < 128, x + 128, np.where(x < 512, 255, np.where(x < 896, 0, x - 896))
                    ).astype(np.uint8)


def jpeg_upsample_plain(plane: np.ndarray, hexp: int, vexp: int) -> np.ndarray:
    """numpy version of the native upsampling of one [h, w] uint8 plane by
    (hexp, vexp) -> [h * vexp, w * hexp]: libjpeg's fancy h2v1 and h2v2 (w
    over 2) and h1v2 triangles, else replication; edges replicated."""
    p = np.asarray(plane, np.int32)
    h, w = p.shape

    def horizontal(s, bias_l, bias_r, shift):  # 3/4 near + 1/4 far across the columns
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        out = np.empty((s.shape[0], 2 * w), np.int32)
        out[:, 0::2] = (3 * s + left + bias_l) >> shift
        out[:, 1::2] = (3 * s + right + bias_r) >> shift
        return out

    if vexp == 2 and (hexp == 1 or (hexp == 2 and w > 2)):
        up = 3 * p + np.concatenate([p[:1], p[:-1]], 0)  # the row above weighs 1/4
        down = 3 * p + np.concatenate([p[1:], p[-1:]], 0)
        out = np.empty((2 * h, hexp * w), np.int32)
        if hexp == 1:
            out[0::2], out[1::2] = (up + 1) >> 2, (down + 2) >> 2
        else:
            out[0::2], out[1::2] = horizontal(up, 8, 7, 4), horizontal(down, 8, 7, 4)
    elif (hexp, vexp) == (2, 1) and w > 2:
        out = horizontal(p, 1, 2, 2)
    else:
        out = np.repeat(np.repeat(p, vexp, 0), hexp, 1)
    return out.astype(np.uint8)


def jpeg_ycc_rgb_plain(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """numpy version of the native YCbCr -> RGB (jdcolor.c's tables at
    SCALEBITS = 16, ONE_HALF rounding) -> [..., 3] uint8."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(c):
        return int(c * 65536 + 0.5)

    cr_r, cb_b = (fix(1.402) * x + half) >> 16, (fix(1.772) * x + half) >> 16
    cr_g, cb_g = -fix(0.71414) * x, -fix(0.34414) * x + half
    y, cb, cr = (np.asarray(a).astype(np.int64) for a in (y, cb, cr))
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def jpeg_ycck_cmyk_plain(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                         k: np.ndarray) -> np.ndarray:
    """numpy version of the native YCCK -> CMYK (jdcolor.c::ycck_cmyk_convert:
    YCbCr -> RGB, then 255 minus each; K unchanged) -> [..., 4] uint8."""
    rgb = jpeg_ycc_rgb_plain(y, cb, cr)
    return np.concatenate([255 - rgb, np.asarray(k, np.uint8)[..., None]], -1)


# libjpeg-turbo's block smoothing (jdcoefct.c::decompress_smooth_data): for
# coefficients 1-9 (zigzag), the natural position and the weights on the
# 5x5 DC window with DC interpolation (no AC coefficient coded at all) and
# without it (the 5x5 cross; coefficients 6-9 are then not estimated)
_SMOOTH = (
    (1, [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
         [-1, -1, 0, 1, 1]],
     [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5]),
    (8, None, None),  # AC10: the transpose of AC01
    (16, [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
     [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]]),
    (9, [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
     [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]]),
    (2, None, None),  # AC02: the transpose of AC20
    (3, [[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5], None),
    (10, [[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5], None),
    (17, None, None),  # AC21: the transpose of AC12
    (24, None, None),  # AC30: the transpose of AC03
)
_SMOOTH_DC = [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
              [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]]


def _smooth_weights():
    out = []
    for i, (pos, interp, cross) in enumerate(_SMOOTH):
        if interp is None:  # the transpose of an earlier one
            src = {1: 0, 4: 2, 7: 6, 8: 5}[i]
            interp = np.asarray(out[src][1]).T
            cross = None if out[src][2] is None else np.asarray(out[src][2]).T
        out.append((pos, np.asarray(interp), None if cross is None else np.asarray(cross)))
    return out


def jpeg_smooth_plain(coef: np.ndarray, dc: np.ndarray, qtable: np.ndarray,
                      coef_bits: np.ndarray) -> np.ndarray:
    """numpy version of the native block-smoothing estimate of each block:
    [N, 64] coefficients (natural order), [N, 25] the 5x5 DC values around
    each (row by row, its own at 12), a [64] quantization table, coef_bits
    of coefficients 0-9 (the Al each was last coded at, -1 never) -> [N, 64]
    int16. A coefficient still zero and short of full precision gets
    Q00 * (weights . DC) / Q_k, rounded half away from zero and capped at
    2**Al - 1; with no AC coefficient coded the DC is re-estimated too."""
    out = np.array(coef, np.int64).reshape(-1, 64)
    dcs = np.asarray(dc, np.int64).reshape(-1, 25)
    q = np.asarray(qtable, np.int64).reshape(64)
    bits = [int(b) for b in np.asarray(coef_bits).reshape(10)]
    change_dc = all(b == -1 for b in bits[1:])

    def estimate(weights, qk, al):
        num = q[0] * (dcs @ np.asarray(weights).reshape(25))
        pred = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        return np.where(num >= 0, pred, -pred)

    for e, (pos, interp, cross) in enumerate(_smooth_weights()):
        al = bits[e + 1]
        weights = interp if change_dc else cross
        if al == 0 or weights is None:
            continue
        est = estimate(weights, q[pos], al)
        out[:, pos] = np.where(out[:, pos] == 0, est, out[:, pos])
    if change_dc:
        out[:, 0] = estimate(_SMOOTH_DC, q[0], 0)
    return out.astype(np.int16)


def jpeg_undifference_plain(diff: np.ndarray, prev: Optional[np.ndarray], psv: int,
                            precision: int = 8, pt: int = 0) -> np.ndarray:
    """numpy version of the native lossless un-differencing of one row
    (jdlossls.c): sample = (difference + prediction) mod 2**16, the
    prediction from the left sample Ra, the one above Rb and above-left Rc
    by predictor psv (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + (Rb - Rc) / 2,
    6 Rb + (Ra - Rc) / 2, 7 (Ra + Rb) / 2, halves floored), Rb in the first
    column; with prev None the row is a first row: 2**(precision - pt - 1),
    then Ra. -> uint16 samples, before the point transform's scaling."""
    d = np.asarray(diff, np.int64).reshape(-1)
    out = np.empty(d.size, np.int64)
    if prev is None:
        ra = 1 << (precision - pt - 1)
        for x in range(d.size):
            ra = (d[x] + ra) & 0xFFFF
            out[x] = ra
        return out.astype(np.uint16)
    up = np.asarray(prev, np.int64).reshape(-1)
    out[0] = (d[0] + up[0]) & 0xFFFF
    for x in range(1, d.size):
        ra, rb, rc = out[x - 1], up[x], up[x - 1]
        pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]
        out[x] = (d[x] + pred) & 0xFFFF
    return out.astype(np.uint16)


# -- KITTI ---------------------------------------------------------------------


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow PNG -> (flow [H,W,2] float32, valid [H,W] float32):
    channels (u, v, valid), u and v stored as value * 64 + 2^15."""
    img = read_png(path).astype(np.float32)
    flow = (img[:, :, :2] - 2 ** 15) / 64.0
    return flow, img[:, :, 2]


def write_flow_kitti(path: str, flow: np.ndarray, valid: Optional[np.ndarray] = None) -> None:
    """Write [H,W,2] flow as a KITTI 16-bit PNG; valid [H, W] (default: every
    pixel valid, as the JAX package writes)."""
    uv = 64.0 * np.asarray(flow) + 2 ** 15
    if valid is None:
        valid = np.ones(uv.shape[:2])
    out = np.concatenate([uv, np.asarray(valid, np.float64)[..., None]], axis=-1)
    write_png(path, out.astype(np.uint16))


def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI disparity PNG -> (flow [H,W,2] with u=-disp, valid mask)."""
    disp = read_png(path).astype(np.float32) / 256.0
    valid = disp > 0.0
    flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
    return flow, valid


def read_gen(file_name: str):
    """Extension-dispatched reader (`core/utils/frame_utils.py:123-137`):
    images as the numpy arrays PIL gives (see the module docstring), flows
    float32."""
    ext = os.path.splitext(file_name)[-1].lower()
    if ext == ".ppm":
        return read_ppm(file_name)
    if ext == ".png":
        img = read_png(file_name)
        if img.dtype == np.uint16 and img.ndim == 3:  # 16-bit RGB, RGBA, grey+alpha
            img = (img >> 8).astype(np.uint8)  # PIL keeps each sample's high byte
            if img.shape[2] == 2:  # and opens 16-bit grey+alpha as RGBA
                img = img[..., [0, 0, 0, 1]]
        return img
    if ext in (".jpeg", ".jpg"):
        return read_jpeg(file_name)
    if ext in (".bin", ".raw"):
        return np.load(file_name)
    if ext == ".flo":
        return read_flow(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(file_name).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
