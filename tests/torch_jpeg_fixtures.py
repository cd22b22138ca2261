"""JPEG and Adam7-PNG cases for the port's frame decoders, and the committed
fixtures that let the card check them (its machine has no PIL or cv2).

    python tests/torch_jpeg_fixtures.py    # rewrites tests/goldens/jpeg/

This helper imports PIL and cv2, so it runs here and never on the card. It
writes into `tests/goldens/jpeg/`:

  small.npz    every JPEG case of `JPEG_CASES` on the 37x53 real crop and
               every Adam7 PNG of `PNG_KINDS` at ADAM7_HW, each as its file's
               bytes (`file/<name>`) beside PIL's array of it (`pil/<name>`);
  frame_0001.jpg, frame_0002.jpg
               the `real_frames` pair resized to 436x1024 (cv2, bilinear)
               and written by Pillow at 4:2:0, quality 95;
  pair.json    the sha256, shape and dtype of PIL's array of each of the two.

The JPEG cases are encoded by Pillow (`subsampling`, `progressive`,
`optimize`, `restart_marker_rows`/`restart_marker_blocks`, grey, CMYK,
`keep_rgb` for an Adobe-RGB file) and by cv2 (4:4:0 and 4:1:1 sampling,
progressive, restart intervals). The Adam7 PNGs are built by `png_bytes`:
each of the seven passes a small image of its own, its rows filtered with
all five filter types in turn.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
from PIL import Image

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # run as a script from anywhere
from torch_data_trees import real_frames  # noqa: E402

GOLDEN_DIR = os.path.join(_TESTS, "goldens", "jpeg")
PAIR_HW = (436, 1024)  # Sintel frames, the demo's serving size
ADAM7_HW = (40, 44)  # every Adam7 pass at least five rows: each filter type in each pass

# -- JPEG ----------------------------------------------------------------------


def pil_jpeg(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def cv_jpeg(img: np.ndarray, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img, list(params))
    assert ok
    return buf.tobytes()


def _cmyk(img):
    return np.concatenate([img, (255 - img[..., :1])], -1)


# name -> img [H, W, 3] uint8 -> JPEG bytes
JPEG_CASES = {
    "q50": lambda im: pil_jpeg(im, quality=50),
    "q75": lambda im: pil_jpeg(im, quality=75),
    "q95": lambda im: pil_jpeg(im, quality=95),
    "444": lambda im: pil_jpeg(im, quality=90, subsampling=0),
    "422": lambda im: pil_jpeg(im, quality=90, subsampling=1),
    "420": lambda im: pil_jpeg(im, quality=90, subsampling=2),
    "440_cv2": lambda im: cv_jpeg(im, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
    "411_cv2": lambda im: cv_jpeg(im, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    "progressive": lambda im: pil_jpeg(im, quality=90, progressive=True),
    "progressive_444": lambda im: pil_jpeg(im, quality=90, progressive=True, subsampling=0),
    "progressive_cv2": lambda im: cv_jpeg(im, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
    "optimize": lambda im: pil_jpeg(im, quality=85, optimize=True),
    "restart_rows": lambda im: pil_jpeg(im, quality=85, restart_marker_rows=1),
    "restart_blocks": lambda im: pil_jpeg(im, quality=85, restart_marker_blocks=3),
    "restart_cv2": lambda im: cv_jpeg(im, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
    "restart_progressive_cv2": lambda im: cv_jpeg(im, cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
                                                  cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
    "grey": lambda im: pil_jpeg(np.ascontiguousarray(im[..., 1]), quality=85),
    "grey_progressive": lambda im: pil_jpeg(np.ascontiguousarray(im[..., 1]), quality=85,
                                            progressive=True),
    "cmyk": lambda im: pil_jpeg(_cmyk(im), "CMYK", quality=85),
    "adobe_rgb": lambda im: pil_jpeg(im, quality=85, keep_rgb=True),
    "1x1": lambda im: pil_jpeg(np.ascontiguousarray(im[:1, :1]), quality=85),
    "1x1_444": lambda im: pil_jpeg(np.ascontiguousarray(im[:1, :1]), quality=85, subsampling=0),
    "2x3_cv2_411": lambda im: cv_jpeg(np.ascontiguousarray(im[:2, :3]),
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    "q5": lambda im: pil_jpeg(im, quality=5),
    "q100_444": lambda im: pil_jpeg(im, quality=100, subsampling=0),
}


def contents() -> dict:
    """The images the JPEG cases encode: real content at 64x96 (whole MCUs)
    and cropped to 37x53 (partial MCUs), and uniform noise at 37x53."""
    real = real_frames(1, (64, 96))[0]
    noise = np.random.RandomState(18).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    return {"real": real, "real_odd": np.ascontiguousarray(real[5:42, 11:64]), "noise": noise}


def pil_array(data: bytes) -> np.ndarray:
    return np.array(Image.open(io.BytesIO(data)))


# -- Adam7 PNG -------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# name -> (PNG colour type, bit depth): every one the port's decoder takes
PNG_KINDS = {
    "grey1": (0, 1), "grey2": (0, 2), "grey4": (0, 4), "grey8": (0, 8), "grey16": (0, 16),
    "rgb8": (2, 8), "rgb16": (2, 16), "palette1": (3, 1), "palette2": (3, 2),
    "palette4": (3, 4), "palette8": (3, 8), "ga8": (4, 8), "ga16": (4, 16), "rgba8": (6, 8),
    "rgba16": (6, 16),
}


def png_samples(kind: str, hw, seed: int) -> np.ndarray:
    """[h, w, channels] samples of `kind`: a ramp plus noise, so that every
    predictor has work to do."""
    color, depth = PNG_KINDS[kind]
    top = (1 << depth) - 1
    r = np.random.RandomState(seed)
    ramp = np.add.outer(np.arange(hw[0]) * 7, np.arange(hw[1]) * 5)[..., None]
    ramp = ramp * max(1, top // 255) + r.randint(0, max(2, top // 8), (*hw, CHANNELS[color]))
    return (ramp % (top + 1)).astype(np.uint16 if depth == 16 else np.uint8)


def _filter(raster: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Filter each row of raster [h, row_bytes] with PNG filter ftype."""
    x = raster.astype(np.int32)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.hstack([np.zeros_like(x[:, :bpp]), x[:, :-bpp]])
    upleft = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) & 255).astype(np.uint8)


def _raster(sub: np.ndarray, depth: int) -> np.ndarray:
    """[ph, pw, ch] samples -> [ph, row_bytes] packed bytes."""
    ph = sub.shape[0]
    if depth == 16:
        return np.ascontiguousarray(sub.astype(">u2")).reshape(ph, -1).view(np.uint8)
    if depth == 8:
        return sub.astype(np.uint8).reshape(ph, -1)
    shifts = np.arange(depth - 1, -1, -1)
    bits = ((sub.reshape(ph, -1)[..., None] >> shifts) & 1).reshape(ph, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def png_bytes(samples: np.ndarray, color: int, depth: int, interlace: bool) -> bytes:
    """A PNG of samples [h, w, ch]; with interlace, Adam7's seven passes,
    each filtered on its own, row y of pass p with filter (y + p) % 5."""
    h, w = samples.shape[:2]
    ch = CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = []
    for p, (x0, y0, dx, dy) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        raster = _raster(sub, depth)
        for y in range(raster.shape[0]):
            ftype = (y + p) % 5
            raw.append(bytes([ftype]) + _filter(raster, bpp, ftype)[y].tobytes())

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if color == 3:
        pal = np.random.RandomState(depth).randint(0, 256, 3 * (1 << depth)).astype(np.uint8)
        out += chunk(b"PLTE", pal.tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(raw))) + chunk(b"IEND", b"")


# -- the committed fixtures --------------------------------------------------------


def pair_frames() -> list:
    """The `real_frames` pair resized to PAIR_HW (cv2, bilinear)."""
    return [cv2.resize(f, PAIR_HW[::-1], interpolation=cv2.INTER_LINEAR)
            for f in real_frames(2, (188, 314))]


def write_fixtures(out_dir: str = GOLDEN_DIR) -> None:
    os.makedirs(out_dir, exist_ok=True)
    arrays = {}
    img = contents()["real_odd"]
    for name, encode in JPEG_CASES.items():
        data = encode(img)
        arrays[f"file/{name}.jpg"] = np.frombuffer(data, np.uint8)
        arrays[f"pil/{name}.jpg"] = pil_array(data)
    for i, kind in enumerate(PNG_KINDS):
        color, depth = PNG_KINDS[kind]
        data = png_bytes(png_samples(kind, ADAM7_HW, i), color, depth, interlace=True)
        arrays[f"file/adam7_{kind}.png"] = np.frombuffer(data, np.uint8)
        arrays[f"pil/adam7_{kind}.png"] = pil_array(data)
    np.savez_compressed(os.path.join(out_dir, "small.npz"), **arrays)
    digests = {}
    for i, frame in enumerate(pair_frames()):
        name = f"frame_{i + 1:04d}.jpg"
        data = pil_jpeg(frame, quality=95, subsampling=2)
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        ref = pil_array(data)
        digests[name] = {"sha256": hashlib.sha256(ref.tobytes()).hexdigest(),
                         "shape": list(ref.shape), "dtype": str(ref.dtype)}
    with open(os.path.join(out_dir, "pair.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    write_fixtures()
    print("wrote", GOLDEN_DIR, sorted(os.listdir(GOLDEN_DIR)))
