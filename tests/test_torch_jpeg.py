"""The port's JPEG decoder (`native/jpeg.cpp` through `data/frame_utils.py`)
and its Adam7-interlaced PNG decoding, against PIL bit for bit.

Every JPEG case is encoded here by Pillow or cv2 (`torch_jpeg_fixtures.py`:
qualities, 4:4:4 to 4:1:1 sampling, progressive, optimized tables, restart
markers, grey, CMYK, Adobe RGB, 1x1 and partial-MCU sizes) on real content
and on noise, and decoded by the port, by PIL and by the JAX package's
`read_gen`; no case has a tolerance. The numpy versions of the decoder's
pixel stages are held to the native ones, the committed fixtures (the
card's oracle) to PIL; the codings PIL refuses, and truncated streams, must
raise, and the ones it decodes (arithmetic, lossless, YCCK, smoothed
progressive; `test_torch_jpeg_codings.py` holds them all) equal PIL.
Adam7 PNGs are built here, each pass filtered with all five filter types,
for every colour type and bit depth.
"""

import functools
import hashlib
import io
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import torch_jpeg_fixtures as fx
from raft_optical_flow_tpu.data import frame_utils as jfu
from raft_optical_flow_tpu_torch.data import frame_utils as fu
from raft_optical_flow_tpu_torch.data import native


@functools.lru_cache(maxsize=None)
def _contents():
    return fx.contents()


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("content", ["real", "real_odd", "noise"])
@pytest.mark.parametrize("case", sorted(fx.JPEG_CASES))
def test_jpeg_decodes_equal_to_pil(tmp_path, case, content):
    data = fx.JPEG_CASES[case](_contents()[content])
    path = str(tmp_path / ("frame.jpeg" if len(case) % 2 else "frame.jpg"))
    with open(path, "wb") as f:
        f.write(data)
    ref = np.array(Image.open(path))
    for got in (fu.read_gen(path), fu.read_jpeg(path), fu.decode_jpeg(data)):
        _same(got, ref)
    _same(np.array(jfu.read_gen(path)), ref)  # the JAX package's reader: PIL


def test_committed_small_fixtures_equal_pil(tmp_path):
    g = np.load(os.path.join(fx.GOLDEN_DIR, "small.npz"))
    names = [k[len("file/"):] for k in g.files if k.startswith("file/")]
    assert len(names) == (len(fx.JPEG_CASES) + len(fx.PNG_KINDS)
                          + len(fx.CODING_CASES) * len(fx.coding_images()))
    for name in names:
        data, ref = g[f"file/{name}"].tobytes(), g[f"pil/{name}"]
        _same(fx.pil_array(data), ref)  # the golden is what PIL reads here
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        _same(fu.read_gen(path), ref)


def test_committed_pair_equals_pil():
    with open(os.path.join(fx.GOLDEN_DIR, "pair.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == ["frame_0001.jpg", "frame_0001_sof10.jpg", "frame_0002.jpg",
                               "frame_0002_sof10.jpg"]
    for name, want in digests.items():
        path = os.path.join(fx.GOLDEN_DIR, name)
        for arr in (np.array(Image.open(path)), fu.read_gen(path)):
            assert list(arr.shape) == want["shape"] == [*fx.PAIR_HW, 3]
            assert str(arr.dtype) == want["dtype"]
            assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]


# -- the pixel stages: numpy against native ---------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_idct_plain_equals_native(seed):
    r = np.random.RandomState(seed)
    coef = np.rint(r.standard_cauchy((300, 64)) * [1, 10, 100, 1000][seed]).clip(-2047, 2047)
    coef[r.uniform(0, 1, coef.shape) < 0.6] = 0
    coef[:40, 1:] = 0  # DC only: the zero-column and zero-row short cuts
    coef[40:80].reshape(40, 8, 8)[:, 1:, :] = 0  # zero rows below the first
    coef = coef.astype(np.int16)
    top = 256 if seed % 2 else 65536  # 8- and 16-bit tables; far out of range wraps
    q = r.randint(1, top, 64).astype(np.uint16)
    _same(native.jpeg_idct_native(coef, q), fu.jpeg_idct_plain(coef, q))


@pytest.mark.parametrize("hexp,vexp", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (3, 2)])
def test_upsample_plain_equals_native(hexp, vexp):
    r = np.random.RandomState(10 * hexp + vexp)
    for hw in ((1, 1), (1, 2), (2, 3), (3, 1), (5, 7), (9, 16)):
        plane = r.randint(0, 256, hw).astype(np.uint8)
        _same(native.jpeg_upsample_native(plane, hexp, vexp),
              fu.jpeg_upsample_plain(plane, hexp, vexp))


def test_ycc_rgb_plain_equals_native():
    cb, cr = (a.astype(np.uint8).reshape(-1) for a in np.mgrid[0:256, 0:256])
    for y in (0, 1, 16, 77, 128, 200, 235, 254, 255):
        yy = np.full_like(cb, y)
        _same(native.jpeg_ycc_rgb_native(yy, cb, cr), fu.jpeg_ycc_rgb_plain(yy, cb, cr))


# -- what raises -------------------------------------------------------------------


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _sof(marker: int, precision: int = 8) -> bytes:
    comps = b"".join(bytes([i + 1, 0x11, 0]) for i in range(3))
    return b"\xff\xd8" + _segment(marker, bytes([precision]) + struct.pack(">HH", 8, 8)
                                  + b"\x03" + comps) + b"\xff\xd9"


def test_truncated_jpeg_raises_value_error():
    for progressive in (False, True):
        data = fx.pil_jpeg(_contents()["real"], quality=90, progressive=progressive)
        fu.decode_jpeg(data)
        for cut in (200, len(data) // 2, len(data) - 10, len(data) - 2):
            with pytest.raises(OSError):  # PIL
                np.array(Image.open(io.BytesIO(data[:cut])))
            with pytest.raises(ValueError, match="truncated|past the end"):
                fu.decode_jpeg(data[:cut])
    with pytest.raises(ValueError, match="SOI"):
        fu.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_a_huffman_table_with_an_all_ones_code_raises():
    """jdhuff.c refuses a table whose codes reach the all-ones code of a
    length (two 1-bit codes), and PIL with it; the port raises ValueError
    (and checks each code before it fills its 9-bit lookup)."""
    data = fx.JPEG_CASES["q75"](_contents()["real"])
    at = data.index(b"\xff\xc4")
    end = at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]
    bad = data[:at] + _segment(0xC4, b"\x00" + bytes([2] + [0] * 15) + b"\x00\x01") + data[end:]
    with pytest.raises(OSError):
        np.array(Image.open(io.BytesIO(bad)))
    with pytest.raises(ValueError, match="bad Huffman table"):
        fu.decode_jpeg(bad)


def _committed(name):
    g = np.load(os.path.join(fx.GOLDEN_DIR, "small.npz"))
    return g[f"file/{name}"].tobytes(), g[f"pil/{name}"]


@pytest.mark.parametrize("marker,name", [(0xC9, "SOF9"), (0xCA, "SOF10"), (0xCB, "SOF11"),
                                         (0xC3, "SOF3"), (0xC5, "SOF5")])
def test_unsupported_codings_raise_naming_the_marker(marker, name):
    """SOF11 (lossless arithmetic) and SOF5 (hierarchical), which PIL does not
    decode, raise naming the marker. SOF9, SOF10 and SOF3 are decoded: a file
    of that coding equals PIL, and the frame header alone, which is not an
    image, raises ValueError as any file without a scan does."""
    if marker in (0xCB, 0xC5):
        with pytest.raises(NotImplementedError, match=f"{name} "):
            fu.decode_jpeg(_sof(marker))
        return
    with pytest.raises(ValueError, match="EOI before any scan"):
        fu.decode_jpeg(_sof(marker))
    data, ref = _committed({0xC9: "sof9_420", 0xCA: "sof10_420", 0xC3: "sof3_rgb"}[marker]
                           + "@real_odd.jpg")
    assert data[data.index(b"\xff" + bytes([marker])) + 1] == marker
    _same(fu.decode_jpeg(data), ref)
    _same(fx.pil_array(data), ref)


def test_12_bit_ycck_and_unrefined_progressive_raise():
    """12-bit frames, which PIL does not open, raise; YCCK and a progressive
    file whose scans leave coefficients unrefined (libjpeg smooths its
    blocks) decode equal to PIL."""
    with pytest.raises(NotImplementedError, match="12-bit precision"):
        fu.decode_jpeg(_sof(0xC1, precision=12))
    # CMYK with the Adobe APP14 transform flag set to 2: YCCK
    cmyk = fx.JPEG_CASES["cmyk"](_contents()["real"])
    at = cmyk.index(b"\xff\xee")
    assert cmyk[at + 4: at + 9] == b"Adobe"
    ycck = bytearray(cmyk)
    ycck[at + 4 + 11] = 2
    _same(fu.decode_jpeg(bytes(ycck)), np.array(Image.open(io.BytesIO(bytes(ycck)))))
    # a progressive file without its last scan (the luma AC refinement):
    # libjpeg smooths the blocks, and so does the port
    data = fx.JPEG_CASES["progressive"](_contents()["real"])
    last_sos = data.rindex(b"\xff\xda")
    unrefined = data[:last_sos] + b"\xff\xd9"
    _same(fu.decode_jpeg(unrefined), np.array(Image.open(io.BytesIO(unrefined))))


# -- Adam7 PNG ---------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(40, 44), (9, 5), (3, 2), (1, 1)])
@pytest.mark.parametrize("kind", sorted(fx.PNG_KINDS))
def test_adam7_png_equals_pil(tmp_path, kind, hw):
    color, depth = fx.PNG_KINDS[kind]
    samples = fx.png_samples(kind, hw, seed=sum(hw))
    paths = {}
    for interlace in (True, False):
        paths[interlace] = str(tmp_path / f"{kind}_{int(interlace)}.png")
        with open(paths[interlace], "wb") as f:
            f.write(fx.png_bytes(samples, color, depth, interlace))
    ref = np.array(Image.open(paths[True]))
    _same(np.array(Image.open(paths[False])), ref)
    _same(fu.read_gen(paths[True]), ref)
    # read_png keeps every bit, interlaced or not, through either un-filter
    flat = fu.read_png(paths[False])
    _same(fu.read_png(paths[True]), flat)
    with open(paths[True], "rb") as f:
        _same(fu.decode_png(f.read(), fu.png_unfilter_plain), flat)
    if depth == 16:
        _same(flat, samples[..., 0] if color == 0 else samples)
