"""Flow and image file codecs without PIL or cv2: Middlebury .flo, .pfm, PPM
and PNG, with KITTI's 16-bit flow PNGs.

Counterpart of `raft_optical_flow_tpu/data/frame_utils.py`. The JAX package
reads PNGs with PIL and KITTI's 3-channel 16-bit PNGs with cv2; neither is on
the card's machine, so PNG is decoded here: the chunks and zlib (stdlib),
then the row un-filter in the native library (`native/png.cpp`), then numpy
unpacking. `read_png` returns what `np.array(PIL.Image.open(path))` returns
for every file PIL writes: 8-bit grey, grey+alpha, RGB and RGBA as uint8,
1-bit grey as bool, 2- and 4-bit grey scaled to 0-255, palette images as
their indices (uint8), 16-bit grey as uint16; 16-bit RGB, RGBA and
grey+alpha come out as uint16 (PIL truncates those to 8 bits; cv2 does
not). Adam7-interlaced files raise NotImplementedError. `write_png` writes
8- and 16-bit RGB, filter 0.

The .flo, PFM and PPM readers and the un-filter go through the native
library (`data/native.py`, built on first use; a failed build raises); the
`*_plain` functions are their numpy versions, the tests' oracles. `read_gen`
returns numpy arrays where the JAX one returns PIL images; JPEG is not
decoded (NotImplementedError).
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


def decode_png(data: bytes, unfilter=native.png_unfilter_native) -> np.ndarray:
    """PNG bytes -> numpy array (see the module docstring for the types)."""
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
    if interlace:
        raise NotImplementedError("Adam7-interlaced PNG is not decoded")
    ch = _PNG_CHANNELS.get(color)
    if ch is None or depth not in {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(color, (8, 16)):
        raise ValueError(f"PNG color type {color}, bit depth {depth}")
    row_bytes = (w * ch * depth + 7) // 8
    rows = np.frombuffer(bytearray(zlib.decompress(b"".join(idat))), np.uint8)
    unfilter(rows, h, row_bytes, max(1, ch * depth // 8))
    px = rows[: h * (row_bytes + 1)].reshape(h, row_bytes + 1)[:, 1:]
    if depth == 16:
        out = px.view(">u2").reshape(h, w, ch).astype(np.uint16)
    elif depth == 8:
        out = px.reshape(h, w, ch)
    else:  # 1, 2, 4 bits: one channel (grey or palette), packed big-endian
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)
        out = (bits @ (1 << np.arange(depth - 1, -1, -1))).astype(np.uint8)[:, :w, None]
        if color == 0:  # PIL's "1" is bool; "L;2" and "L;4" scale to 0-255
            out = out.astype(bool) if depth == 1 else out * np.uint8(255 // (2 ** depth - 1))
    out = np.ascontiguousarray(out)
    return out[..., 0] if ch == 1 else out


def read_png(path: str) -> np.ndarray:
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
    images as numpy arrays (uint8, or what `read_png` returns), flows float32."""
    ext = os.path.splitext(file_name)[-1].lower()
    if ext == ".ppm":
        return read_ppm(file_name)
    if ext == ".png":
        return read_png(file_name)
    if ext in (".jpeg", ".jpg"):
        raise NotImplementedError(f"{file_name}: JPEG is not decoded (no PIL or cv2 on the card)")
    if ext in (".bin", ".raw"):
        return np.load(file_name)
    if ext == ".flo":
        return read_flow(file_name).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(file_name).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    return []
