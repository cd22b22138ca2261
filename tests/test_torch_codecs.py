"""The port's codecs (`data/frame_utils.py`, `data/native.py`) against the
JAX package's readers (numpy, its native library, PIL and cv2).

PNG is decoded without PIL: every filter type 0-4 is written here by
filtering rows in numpy, and every color type and bit depth PIL writes is
written by PIL's own encoder; each decodes equal to
`np.array(PIL.Image.open(path))`. KITTI's 3-channel 16-bit PNGs are held
against cv2 in both directions.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

from raft_optical_flow_tpu.data import frame_utils as jfu
from raft_optical_flow_tpu.data import native as jnative
from raft_optical_flow_tpu_torch.data import frame_utils as fu
from raft_optical_flow_tpu_torch.data import native
from test_data_layer import _write_pfm, _write_ppm


def test_native_library_builds_into_the_ports_build_dir():
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("libflowdata_")
    assert not [f for f in os.listdir(native.NATIVE_DIR) if not f.endswith(".cpp")]


def test_flo_equals_the_jax_readers(tmp_path):
    flow = np.random.RandomState(0).uniform(-30, 30, (17, 23, 2)).astype(np.float32)
    path = str(tmp_path / "a.flo")
    fu.write_flow(path, flow)
    ref = jfu.read_flow(path)
    for got in (fu.read_flow(path), fu.read_flow_plain(path)):
        assert got.dtype == np.float32 and np.array_equal(got, ref) and np.array_equal(got, flow)
    batch = native.read_flow_batch_native([path, path], num_threads=2)
    assert batch.shape == (2, 17, 23, 2) and np.array_equal(batch[1], flow)
    jpath = str(tmp_path / "j.flo")
    jfu.write_flow(jpath, flow)
    assert open(jpath, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("channels", [1, 3])
def test_pfm_equals_the_jax_readers(tmp_path, little_endian, channels):
    shape = (9, 7, 3) if channels == 3 else (9, 7)
    data = np.random.RandomState(2).randn(*shape).astype(np.float32)
    path = str(tmp_path / "a.pfm")
    _write_pfm(path, data, little_endian)
    ref = jfu.read_pfm(path)
    for got in (fu.read_pfm(path), fu.read_pfm_plain(path)):
        assert got.dtype == np.float32 and np.array_equal(got, ref) and np.array_equal(got, data)
    gen = fu.read_gen(path)
    assert np.array_equal(gen, jfu.read_gen(path))


def test_ppm_equals_pil_and_the_jax_readers(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (11, 13, 3)).astype(np.uint8)
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    _write_ppm(a, img)
    fu.write_ppm(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    with open(str(tmp_path / "c.ppm"), "wb") as f:  # a header comment
        f.write(b"P6\n# made by hand\n13 11\n255\n" + img.tobytes())
    for p in (a, str(tmp_path / "c.ppm")):
        for got in (fu.read_ppm(p), fu.read_ppm_plain(p), fu.read_gen(p)):
            assert np.array_equal(got, np.array(Image.open(p)))
    assert np.array_equal(fu.read_gen(a), jnative.read_ppm_native(a))


# -- PNG -----------------------------------------------------------------------


def _filter_rows(raster, bpp, ftype):
    """Filter each row of raster [h, row_bytes] uint8 with PNG filter ftype."""
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


def _png_bytes(img, depth, color, ftypes):
    """A PNG of img whose row y is filtered with ftypes[y % len(ftypes)]."""
    h, w = img.shape[:2]
    raster = (img.astype(">u2") if depth == 16 else img.astype(np.uint8)).reshape(h, -1)
    raster = np.ascontiguousarray(raster).view(np.uint8).reshape(h, -1)
    bpp = max(1, raster.shape[1] // w)
    rows = [np.concatenate([[ftypes[y % len(ftypes)]],
                            _filter_rows(raster, bpp, ftypes[y % len(ftypes)])[y]])
            for y in range(h)]

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body))

    out = fu.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    raw = np.concatenate(rows).astype(np.uint8).tobytes()
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey16", "rgb16"])
def test_png_filters_decode_equal_to_pil(tmp_path, ftype, kind):
    rng = np.random.RandomState(3)
    depth, color, shape = {"rgb8": (8, 2, (13, 21, 3)), "rgba8": (8, 6, (13, 21, 4)),
                           "grey16": (16, 0, (13, 21)), "rgb16": (16, 2, (13, 21, 3))}[kind]
    # smooth content with noise, so every predictor has work to do
    ramp = np.add.outer(np.arange(shape[0]) * 7, np.arange(shape[1]) * 5)
    ramp = ramp.reshape(ramp.shape + (1,) * (len(shape) - 2))
    top = 65535 if depth == 16 else 255
    img = ((ramp * (top // 255) + rng.randint(0, top // 8, shape)) % (top + 1)).astype(
        np.uint16 if depth == 16 else np.uint8)
    ftypes = [0, 1, 2, 3, 4] if ftype == "mixed" else [ftype]
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(img, depth, color, ftypes))
    got = fu.read_png(path)
    assert got.dtype == img.dtype and np.array_equal(got, img)
    if kind == "rgb16":  # PIL keeps 8 bits of 16-bit RGB; cv2 reads all 16
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    else:
        ref = np.array(Image.open(path))
    assert np.array_equal(got, ref)
    assert np.array_equal(fu.decode_png(open(path, "rb").read(), fu.png_unfilter_plain), got)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16", "1", "P2", "P4", "P16",
                                  "P256"])
def test_png_written_by_pil_decodes_equal(tmp_path, mode):
    rng = np.random.RandomState(4)
    shape = (19, 37)
    if mode.startswith("P"):
        n = int(mode[1:])
        im = Image.fromarray(rng.randint(0, n, shape).astype(np.uint8), "P")
        im.putpalette(list(rng.randint(0, 256, 3 * n)))
    elif mode == "1":
        im = Image.fromarray(rng.uniform(0, 1, shape) > 0.5)
    elif mode == "I;16":
        im = Image.fromarray(rng.randint(0, 65536, shape).astype(np.uint16))
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        a = rng.randint(0, 256, shape + (ch,)).astype(np.uint8)
        im = Image.fromarray(a[..., 0] if ch == 1 else a, mode)
    path = str(tmp_path / "p.png")
    im.save(path)
    ref = np.array(Image.open(path))
    got = fu.read_png(path)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(fu.read_gen(path), ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_writer_read_by_pil_and_cv2(tmp_path, dtype):
    rng = np.random.RandomState(5)
    img = rng.randint(0, np.iinfo(dtype).max + 1, (23, 31, 3)).astype(dtype)
    path = str(tmp_path / "w.png")
    fu.write_png(path, img)
    assert np.array_equal(fu.read_png(path), img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1], img)
    if dtype == np.uint8:  # PIL keeps 8 bits of 16-bit RGB
        assert np.array_equal(np.array(Image.open(path)), img)
    with pytest.raises(ValueError, match="H, W, 3"):
        fu.write_png(path, img[..., 0])


def test_png_interlaced_raises(tmp_path):
    """An Adam7 PNG header with no image data raises ValueError (Adam7 files
    decode: tests/test_torch_jpeg.py), and `read_gen` on a .jpg and a .jpeg
    returns PIL's array (it raised NotImplementedError before JPEG was
    decoded)."""
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    body = fu.PNG_SIGNATURE + struct.pack(">I", 13) + b"IHDR" + ihdr \
        + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
    with pytest.raises(ValueError, match="IDAT"):
        fu.decode_png(body)
    img = np.random.RandomState(8).randint(0, 256, (13, 21, 3)).astype(np.uint8)
    for name in ("frame.jpg", "frame.jpeg"):
        path = str(tmp_path / name)
        Image.fromarray(img).save(path, "JPEG", quality=90)
        ref = np.array(Image.open(path))
        got = fu.read_gen(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape and np.array_equal(got, ref)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_numpy(bpp):
    rng = np.random.RandomState(bpp)
    h, row_bytes = 9, 5 * bpp + (1 if bpp == 1 else 0)
    rows = rng.randint(0, 256, (h, row_bytes + 1)).astype(np.uint8)
    rows[:, 0] = [0, 1, 2, 3, 4, 4, 3, 2, 1]
    a, b = rows.reshape(-1).copy(), rows.reshape(-1).copy()
    native.png_unfilter_native(a, h, row_bytes, bpp)
    fu.png_unfilter_plain(b, h, row_bytes, bpp)
    assert np.array_equal(a, b)
    bad = rows.reshape(-1).copy()
    bad[0] = 5
    with pytest.raises(ValueError, match="filter"):
        native.png_unfilter_native(bad, h, row_bytes, bpp)


# -- KITTI ---------------------------------------------------------------------


def test_kitti_flow_against_cv2_both_ways(tmp_path):
    rng = np.random.RandomState(6)
    flow = np.round(rng.uniform(-40, 40, (15, 27, 2)) * 64) / 64
    valid = (rng.uniform(0, 1, (15, 27)) > 0.5).astype(np.float64)
    ours = str(tmp_path / "ours.png")
    fu.write_flow_kitti(ours, flow, valid)
    jf, jv = jfu.read_flow_kitti(ours)  # the JAX package's cv2 reader
    assert np.array_equal(jf, flow.astype(np.float32)) and np.array_equal(jv, valid)
    theirs = str(tmp_path / "theirs.png")
    jfu.write_flow_kitti(theirs, flow)  # cv2's writer, every pixel valid
    f, v = fu.read_flow_kitti(theirs)
    rf, rv = jfu.read_flow_kitti(theirs)
    assert np.array_equal(f, rf) and np.array_equal(v, rv) and v.min() == 1.0
    # the port's writer without a mask writes the JAX package's pixels
    fu.write_flow_kitti(ours, flow)
    assert np.array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                          cv2.imread(theirs, cv2.IMREAD_UNCHANGED))


def test_kitti_disparity_equals_the_jax_reader(tmp_path):
    disp = np.random.RandomState(7).randint(0, 65536, (12, 20)).astype(np.uint16)
    disp[::3] = 0
    path = str(tmp_path / "d.png")
    Image.fromarray(disp).save(path)
    for got, ref in zip(fu.read_disp_kitti(path), jfu.read_disp_kitti(path)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
