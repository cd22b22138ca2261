"""JPEG and Adam7-PNG cases for the port's frame decoders, and the committed
fixtures that let the card check them (its machine has no PIL or cv2).

    python tests/torch_jpeg_fixtures.py    # rewrites tests/goldens/jpeg/

This helper imports PIL and cv2, so it runs here and never on the card. It
writes into `tests/goldens/jpeg/`:

  small.npz    every JPEG case of `JPEG_CASES` on the 37x53 real crop, every
               case of `CODING_CASES` on each image of `coding_images()`,
               and every Adam7 PNG of `PNG_KINDS` at ADAM7_HW, each as its
               file's bytes (`file/<name>`) beside PIL's array of it
               (`pil/<name>`);
  frame_0001.jpg, frame_0002.jpg
               the `real_frames` pair resized to 436x1024 (cv2, bilinear)
               and written by Pillow at 4:2:0, quality 95;
  frame_0001_sof10.jpg, frame_0002_sof10.jpg
               the same pair written arithmetic-coded and progressive
               (SOF10) at 4:2:0, quality 90, by `jpeg_writer.c` (each under
               64 KiB: PIL feeds libjpeg 64 KiB at a time, and libjpeg's
               arithmetic decoder cannot wait for more data, so PIL fails
               on an arithmetic-coded segment that crosses such a boundary;
               at quality 95 the frames are 89 KB and PIL refuses them);
  pair.json    the sha256, shape and dtype of PIL's array of each of the four;

and `tests/goldens/grain_stream.json`: the record indices of the batches
that grain's `DataLoader` gives (`IndexSampler`, shuffled, endless;
`Batch`) at worker_count 0 and 4 for GRAIN_STREAM's dataset size, batch
size and seed, the order the port's `GrainFlowLoader` must give on the card
(which has no grain), and unshuffled at worker_count 2 (tier-1 compares
the port with grain's worker processes once, shuffled; each such grain run
costs about 12 s).

The JPEG cases are encoded by Pillow (`subsampling`, `progressive`,
`optimize`, `restart_marker_rows`/`restart_marker_blocks`, grey, CMYK,
`keep_rgb` for an Adobe-RGB file) and by cv2 (4:4:0 and 4:1:1 sampling,
progressive, restart intervals). The coding cases are written by
`jpeg_writer.c`, which `writer()` compiles with gcc: against the system's
libjpeg-turbo (arithmetic coding with and without a DAC marker, YCCK,
custom progressive scan scripts that leave coefficients unrefined, so that
libjpeg smooths the blocks) and against Pillow's bundled libjpeg-turbo 3
(lossless, `jpeg_enable_lossless`). The Adam7 PNGs are built by `png_bytes`:
each of the seven passes a small image of its own, its rows filtered with
all five filter types in turn.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import cv2
import numpy as np
from PIL import Image

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # run as a script from anywhere
from torch_data_trees import real_frames  # noqa: E402

GOLDEN_DIR = os.path.join(_TESTS, "goldens", "jpeg")
GRAIN_STREAM_PATH = os.path.join(_TESTS, "goldens", "grain_stream.json")
# the card's loader check: chip_smoke.py's chairs tree (10 pairs), batch 10,
# seed 1234, and as many batches as it takes
GRAIN_STREAM = {"num_records": 10, "batch_size": 10, "seed": 1234, "batches": 10}
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


# -- the codings Pillow and cv2 do not write: jpeg_writer.c --------------------------


def _pillow_libjpeg() -> str:
    import glob

    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs",
                                  "libjpeg-*.so*"))
    if not libs:
        raise FileNotFoundError("no libjpeg in Pillow's bundled libraries")
    return os.path.abspath(libs[0])


_WRITERS = {}


def writer(lossless: bool = False) -> str:
    """jpeg_writer.c compiled against the system's libjpeg-turbo, or (lossless)
    against Pillow's bundled libjpeg-turbo 3; built once per process."""
    if lossless not in _WRITERS:
        out = os.path.join(tempfile.mkdtemp(prefix="jpeg_writer_"), "jw")
        src = os.path.join(_TESTS, "jpeg_writer.c")
        if lossless:
            lib = _pillow_libjpeg()
            cmd = ["gcc", "-O1", "-DLOSSLESS", "-o", out, src, lib,
                   f"-Wl,-rpath,{os.path.dirname(lib)}"]
        else:
            cmd = ["gcc", "-O1", "-o", out, src, "-ljpeg"]
        subprocess.run(cmd, check=True, capture_output=True)
        _WRITERS[lossless] = out
    return _WRITERS[lossless]


def write_jpeg(img: np.ndarray, *args: str, lossless: bool = False) -> bytes:
    """img [H, W] grey, [H, W, 3] RGB or [H, W, 4] CMYK -> the writer's JPEG."""
    channels = 1 if img.ndim == 2 else img.shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        np.ascontiguousarray(img, np.uint8).tofile(raw)
        subprocess.run([writer(lossless), raw, out, str(img.shape[1]), str(img.shape[0]),
                        str(channels), *args], check=True, capture_output=True)
        with open(out, "rb") as f:
            return f.read()


def strip_markers(data: bytes, marker: int) -> bytes:
    """data without its marker segments of type `marker` (before the first SOS)."""
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        n = 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
        if data[p + 1] != marker:
            out += data[p:p + n]
        p += n
    return bytes(out + data[p:])


def without_last_scan(data: bytes) -> bytes:
    return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"


def _grey(im):
    return np.ascontiguousarray(im[..., 1])


# name -> (the image's kind: rgb, grey or cmyk; img -> JPEG bytes). Each is
# one coding that PIL decodes and Pillow's and cv2's encoders do not write.
_DC_ONLY = "scans=0,1,2:0:0:0:0"
_DC_AC15 = "scans=0,1,2:0:0:0:0;0:1:5:0:2"
CODING_CASES = {
    # arithmetic coding, sequential (SOF9)
    "sof9_420": ("rgb", lambda im: write_jpeg(im, "arith=1")),
    "sof9_444": ("rgb", lambda im: write_jpeg(im, "arith=1", "sampling=1x1,1x1,1x1")),
    "sof9_grey": ("grey", lambda im: write_jpeg(im, "arith=1")),
    "sof9_420_restart": ("rgb", lambda im: write_jpeg(im, "arith=1", "restart=2")),
    "sof9_grey_restart": ("grey", lambda im: write_jpeg(im, "arith=1", "restart=1")),
    "sof9_dac": ("rgb", lambda im: write_jpeg(im, "arith=1", "dac=2,6,12")),
    "sof9_no_dac": ("rgb", lambda im: strip_markers(write_jpeg(im, "arith=1"), 0xCC)),
    # arithmetic coding, progressive (SOF10)
    "sof10_420": ("rgb", lambda im: write_jpeg(im, "arith=1", "progressive=1")),
    "sof10_444": ("rgb", lambda im: write_jpeg(im, "arith=1", "progressive=1",
                                               "sampling=1x1,1x1,1x1")),
    "sof10_grey": ("grey", lambda im: write_jpeg(im, "arith=1", "progressive=1")),
    "sof10_420_restart": ("rgb", lambda im: write_jpeg(im, "arith=1", "progressive=1",
                                                       "restart=3")),
    "sof10_dac": ("rgb", lambda im: write_jpeg(im, "arith=1", "progressive=1", "dac=1,3,2")),
    "sof10_no_dac": ("rgb", lambda im: strip_markers(
        write_jpeg(im, "arith=1", "progressive=1"), 0xCC)),
    # block smoothing: progressive scans that leave coefficients 1-9 unrefined
    "smooth_unrefined": ("rgb", lambda im: without_last_scan(
        pil_jpeg(im, quality=90, progressive=True))),
    "smooth_unrefined_sof10": ("rgb", lambda im: without_last_scan(
        write_jpeg(im, "arith=1", "progressive=1"))),
    "smooth_dc_only": ("rgb", lambda im: write_jpeg(im, _DC_ONLY)),
    "smooth_dc_ac15": ("rgb", lambda im: write_jpeg(im, _DC_AC15)),
    "smooth_dc_ac15_sof10": ("rgb", lambda im: write_jpeg(im, "arith=1", _DC_AC15)),
    "smooth_grey_dc": ("grey", lambda im: write_jpeg(im, "scans=0:0:0:0:1")),
    "smooth_440_split": ("rgb", lambda im: write_jpeg(
        im, "sampling=1x2,1x1,1x1", "scans=0,1,2:0:0:0:0;0:1:9:0:1;1:1:2:0:3;2:1:63:0:0")),
    # YCCK (Adobe transform 2), K at full and at half resolution
    "ycck_11": ("cmyk", lambda im: write_jpeg(im, "space=ycck", "sampling=1x1,1x1,1x1,1x1")),
    "ycck_22": ("cmyk", lambda im: write_jpeg(im, "space=ycck", "sampling=2x2,1x1,1x1,2x2")),
    "ycck_k11": ("cmyk", lambda im: write_jpeg(im, "space=ycck", "sampling=2x2,1x1,1x1,1x1")),
    # lossless (SOF3): predictors 1-7, point transforms 0 and 2, restarts
    **{f"sof3_p{psv}_pt{pt}": ("grey", lambda im, psv=psv, pt=pt: write_jpeg(
        im, f"lossless={psv},{pt}", lossless=True)) for psv in range(1, 8) for pt in (0, 2)},
    "sof3_grey_restart": ("grey", lambda im: write_jpeg(im, "lossless=4,0", "restart_rows=2",
                                                        lossless=True)),
    "sof3_rgb": ("rgb", lambda im: write_jpeg(im, "lossless=6,0", "space=rgb", lossless=True)),
    "sof3_ycc_pt2": ("rgb", lambda im: write_jpeg(im, "lossless=7,2", "space=ycc",
                                                  lossless=True)),
    "sof3_rgb_restart": ("rgb", lambda im: write_jpeg(im, "lossless=5,1", "space=rgb",
                                                      "restart_rows=1", lossless=True)),
}


def coding_images() -> dict:
    """The images of the coding cases: the 37x53 real crop and noise, and
    real crops of odd sizes down to 1x1."""
    c = contents()
    out = {"real_odd": c["real_odd"], "noise": c["noise"]}
    for h, w in ((1, 1), (2, 3), (9, 17)):
        out[f"real_{h}x{w}"] = np.ascontiguousarray(c["real"][:h, :w])
    return out


def coding_image(img: np.ndarray, kind: str) -> np.ndarray:
    if kind == "grey":
        return _grey(img)
    if kind == "cmyk":
        return _cmyk(img)
    return img


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
    for name, (kind, encode) in CODING_CASES.items():
        for image_name, image in coding_images().items():
            data = encode(coding_image(image, kind))
            key = f"{name}@{image_name}.jpg"
            arrays[f"file/{key}"] = np.frombuffer(data, np.uint8)
            arrays[f"pil/{key}"] = pil_array(data)
    for i, kind in enumerate(PNG_KINDS):
        color, depth = PNG_KINDS[kind]
        data = png_bytes(png_samples(kind, ADAM7_HW, i), color, depth, interlace=True)
        arrays[f"file/adam7_{kind}.png"] = np.frombuffer(data, np.uint8)
        arrays[f"pil/adam7_{kind}.png"] = pil_array(data)
    np.savez_compressed(os.path.join(out_dir, "small.npz"), **arrays)
    digests = {}
    for i, frame in enumerate(pair_frames()):
        for name, data in ((f"frame_{i + 1:04d}.jpg", pil_jpeg(frame, quality=95, subsampling=2)),
                           (f"frame_{i + 1:04d}_sof10.jpg",
                            write_jpeg(frame, "arith=1", "progressive=1", "quality=90",
                                       "sampling=2x2,1x1,1x1"))):
            with open(os.path.join(out_dir, name), "wb") as f:
                f.write(data)
            ref = pil_array(data)
            digests[name] = {"sha256": hashlib.sha256(ref.tobytes()).hexdigest(),
                             "shape": list(ref.shape), "dtype": str(ref.dtype)}
    with open(os.path.join(out_dir, "pair.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")


# -- grain's record stream ---------------------------------------------------------


class _Indices:
    """A grain data source whose record i is i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.int64(i)


def grain_batches(num_records, batch_size, seed, worker_count, batches, shuffle=True):
    """The record indices of the first `batches` batches grain's DataLoader
    gives as the JAX `GrainFlowLoader` sets it up."""
    import grain.python as gp

    sampler = gp.IndexSampler(num_records=num_records, shard_options=gp.NoSharding(),
                              shuffle=shuffle, num_epochs=None, seed=seed)
    loader = gp.DataLoader(data_source=_Indices(num_records), sampler=sampler,
                           operations=[gp.Batch(batch_size=batch_size, drop_remainder=True)],
                           worker_count=worker_count)
    it = iter(loader)
    return [np.asarray(next(it)).tolist() for _ in range(batches)]


def write_grain_stream(path: str = GRAIN_STREAM_PATH) -> None:
    g = GRAIN_STREAM
    n, bs, seed, nb = g["num_records"], g["batch_size"], g["seed"], g["batches"]
    out = dict(g, shuffle=True, batches={str(w): grain_batches(n, bs, seed, w, nb) for w in (0, 4)},
               batches_no_shuffle={"2": grain_batches(n, bs, seed, 2, nb, shuffle=False)})
    with open(path, "w") as f:
        json.dump(out, f)
        f.write("\n")


if __name__ == "__main__":
    write_fixtures()
    write_grain_stream()
    print("wrote", GOLDEN_DIR, sorted(os.listdir(GOLDEN_DIR)), "and", GRAIN_STREAM_PATH)
