"""The JPEG codings that PIL decodes and Pillow's and cv2's encoders do not
write, through the port's decoder (`native/jpeg.cpp`), against PIL bit for
bit: arithmetic coding (SOF9, SOF10; restart intervals; with and without a
DAC marker), block smoothing of progressive files whose scans leave
coefficients unrefined (a missing last scan, DC-only, DC and one AC 1-5
scan; Huffman and arithmetic), YCCK (K at full and half resolution) and
lossless SOF3 (predictors 1-7, point transforms 0 and 2, restarts, grey,
RGB and YCbCr). Each case is committed in `tests/goldens/jpeg/small.npz`
(written by `torch_jpeg_fixtures.py` with `jpeg_writer.c`) on the 37x53
real crop, noise and real crops of 1x1, 2x3 and 9x17; no case has a
tolerance. The numpy versions of the new pixel stages (the smoothing
estimate, YCCK -> CMYK, a lossless row's un-differencing) are held to the
native ones, and what PIL refuses still raises.
"""

import functools
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import torch_jpeg_fixtures as fx
from raft_optical_flow_tpu_torch.data import frame_utils as fu
from raft_optical_flow_tpu_torch.data import native


@functools.lru_cache(maxsize=None)
def _small():
    g = np.load(os.path.join(fx.GOLDEN_DIR, "small.npz"))
    return {k: g[k] for k in g.files}


def _case_keys():
    return sorted(f"{case}@{image}.jpg" for case in fx.CODING_CASES
                  for image in ("real_odd", "noise", "real_1x1", "real_2x3", "real_9x17"))


def _markers(data: bytes):
    """The marker types before the first SOS, and the SOS count."""
    out, p = [], 2
    while data[p + 1] != 0xDA:
        out.append(data[p + 1])
        p += 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
    return out, data.count(b"\xff\xda")


# what each family of cases must be: its SOF marker
_SOF = {"sof9": 0xC9, "sof10": 0xCA, "sof3": 0xC3, "ycck": 0xC0, "smooth": None}


@pytest.mark.parametrize("key", _case_keys())
def test_coding_equals_pil(tmp_path, key):
    g = _small()
    data, ref = g[f"file/{key}"].tobytes(), g[f"pil/{key}"]
    assert np.array_equal(fx.pil_array(data), ref)  # the golden is what PIL reads here
    case = key.split("@")[0]
    markers, n_scans = _markers(data)
    sof = _SOF[case.split("_")[0]]
    if sof is not None:
        assert sof in markers
    if case.startswith("smooth"):
        assert {0xC2, 0xCA} & set(markers) and n_scans < 10  # progressive, scans left out
    if case.endswith("no_dac"):
        assert 0xCC not in markers
    elif case.startswith(("sof9", "sof10")):
        assert 0xCC in markers
    if case.startswith("ycck"):
        assert ref.shape[-1] == 4 and b"Adobe" in data
    path = str(tmp_path / "frame.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for got in (fu.decode_jpeg(data), fu.read_gen(path)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref)


def test_every_case_is_committed():
    keys = {k[len("file/"):] for k in _small() if k.startswith("file/") and "@" in k}
    assert keys == set(_case_keys())


def test_smoothing_changes_what_unsmoothed_decoding_gives():
    """A DC-only file decodes without smoothing to blocks of one value each
    (a DC-only block's IDCT is flat); PIL's, and the port's, are not flat:
    libjpeg smoothed them (a decoder that skipped it would fail above)."""
    g = _small()
    data = g["file/smooth_dc_only@real_odd.jpg"].tobytes()
    ref = g["pil/smooth_dc_only@real_odd.jpg"]
    assert 0xC2 in _markers(data)[0]
    grey = fu.decode_jpeg(g["file/smooth_grey_dc@real_odd.jpg"].tobytes())
    for img in (ref, grey):
        blocks = img[:32, :48].reshape(4, 8, 6, 8, -1)
        assert (blocks.std(axis=(1, 3)) > 0).mean() > 0.5


def test_arithmetic_files_pil_reads_in_one_go():
    """PIL feeds libjpeg `decodermaxblock` bytes at a time (64 KiB), and
    libjpeg's arithmetic decoder cannot wait for more data: an
    arithmetic-coded segment across such a boundary fails in PIL ("broken
    data stream"; a 436x1024 frame at quality 95 is 89 KB). The committed
    SOF10 frames are under 64 KiB; read in 4 KiB pieces PIL refuses them,
    read whole it gives the port's array. The port reads such files whole."""
    path = os.path.join(fx.GOLDEN_DIR, "frame_0001_sof10.jpg")
    with open(path, "rb") as f:
        data = f.read()
    assert 4096 < len(data) < 65536
    im = Image.open(io.BytesIO(data))
    im.decodermaxblock = 4096
    with pytest.raises(OSError):
        im.load()
    assert np.array_equal(fu.decode_jpeg(data), np.array(Image.open(io.BytesIO(data))))


# -- the pixel stages: numpy against native ---------------------------------------


@pytest.mark.parametrize("bits", [
    [0, -1, -1, -1, -1, -1, -1, -1, -1, -1],  # DC only: DC interpolation
    [2, -1, -1, -1, -1, -1, -1, -1, -1, -1],
    [0, 2, 2, 2, 2, 2, -1, -1, -1, -1],  # one AC 1-5 scan at Al 2
    [0, 1, 0, 3, -1, 0, 2, 1, 0, 4],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0],  # refined: nothing to estimate
])
def test_smooth_plain_equals_native(bits):
    r = np.random.RandomState(sum(b + 2 for b in bits))
    n = 400
    coef = np.where(r.uniform(0, 1, (n, 64)) < 0.6, 0, r.randint(-60, 60, (n, 64)))
    coef = coef.astype(np.int16)
    dc = np.rint(r.standard_cauchy((n, 25)) * 200).clip(-2047, 2047).astype(np.int32)
    dc[:50] = dc[:50, 12:13]  # flat neighbourhoods
    q = r.randint(1, 120, 64).astype(np.uint16)
    got = native.jpeg_smooth_native(coef, dc, q, np.array(bits))
    assert np.array_equal(got, fu.jpeg_smooth_plain(coef, dc, q, np.array(bits)))
    if bits[1] != 0:
        assert (got != coef).any()
    else:
        assert np.array_equal(got, coef)


def test_ycck_cmyk_plain_equals_native():
    r = np.random.RandomState(5)
    cb, cr = (a.astype(np.uint8).reshape(-1) for a in np.mgrid[0:256, 0:256])
    for y in (0, 16, 128, 235, 255):
        k = r.randint(0, 256, cb.size).astype(np.uint8)
        yy = np.full_like(cb, y)
        got = native.jpeg_ycck_cmyk_native(yy, cb, cr, k)
        assert np.array_equal(got, fu.jpeg_ycck_cmyk_plain(yy, cb, cr, k))
        assert np.array_equal(got[..., 3], k)


@pytest.mark.parametrize("psv", range(1, 8))
def test_undifference_plain_equals_native(psv):
    r = np.random.RandomState(psv)
    for width in (1, 2, 37):
        diff = r.randint(-40000, 40000, width)
        diff[r.uniform(0, 1, width) < 0.1] = 32768  # SSSS 16
        prev = r.randint(0, 65536, width)
        for above in (prev, None):
            for pt in (0, 2):
                got = native.jpeg_undifference_native(diff, above, psv, pt=pt)
                assert got.dtype == np.uint16
                assert np.array_equal(got, fu.jpeg_undifference_plain(diff, above, psv, pt=pt))


# -- what PIL refuses ----------------------------------------------------------------


def _patched(key: str, marker=None, precision=None) -> bytes:
    """A committed fixture with its SOF marker type and/or precision byte changed."""
    data = bytearray(_small()[f"file/{key}"].tobytes())
    p = 2
    while not (0xC0 <= data[p + 1] <= 0xCF and data[p + 1] not in (0xC4, 0xC8, 0xCC)):
        p += 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
    if marker is not None:
        data[p + 1] = marker
    if precision is not None:
        data[p + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("key,marker,precision,pattern", [
    ("sof3_p1_pt0@real_odd.jpg", 0xCB, None, "SOF11"),  # lossless, arithmetic
    ("q75.jpg", 0xC5, None, "SOF5"), ("q75.jpg", 0xC6, None, "SOF6"),
    ("q75.jpg", 0xC7, None, "SOF7"), ("sof9_420@real_odd.jpg", 0xCD, None, "SOF13"),
    ("sof10_420@real_odd.jpg", 0xCE, None, "SOF14"), ("sof3_p1_pt0@real_odd.jpg", 0xCF, None,
                                                      "SOF15"),
    ("q75.jpg", None, 12, "12-bit"), ("q75.jpg", 0xC1, 16, "16-bit"),
    ("progressive.jpg", None, 12, "12-bit"), ("sof9_420@real_odd.jpg", None, 12, "12-bit"),
    ("sof3_p1_pt0@real_odd.jpg", None, 12, "12-bit"), ("sof3_p1_pt0@real_odd.jpg", None, 16,
                                                       "16-bit"),
    ("sof3_p1_pt0@real_odd.jpg", None, 6, "6-bit"), ("sof3_p1_pt0@real_odd.jpg", None, 2,
                                                     "2-bit"),
])
def test_what_pil_refuses_raises_naming_it(key, marker, precision, pattern):
    """Files whose frame header names a coding or a precision that PIL does
    not decode (libjpeg-turbo refuses the hierarchical and lossless
    arithmetic processes; PIL opens 8-bit frames only): PIL raises, and the
    port raises NotImplementedError naming it. No encoder here writes such
    files, so they are made by patching the committed ones."""
    data = _patched(key, marker, precision)
    with pytest.raises(OSError):  # PIL: "cannot identify image file" or a decoder error
        np.array(Image.open(io.BytesIO(data)))
    with pytest.raises(NotImplementedError, match=pattern):
        fu.decode_jpeg(data)
