"""`data/cv.py` against cv2, and `utils/flow_viz.py` against the JAX
package's.

The HSV conversions are held equal on every input: all 2^24 RGB colours and
all 180 x 256 x 256 HSV triples (in both of cv2's code paths). The resize is held at the augmentors'
scale ranges (`fetch_dataset`'s min/max scales, stretched and not, the
min-scale floor): uint8 images equal to cv2, float32 flows equal (2
channels) and 3-channel float32 within 1e-6 of the output's largest
magnitude.
"""

import cv2
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from raft_optical_flow_tpu.utils import flow_viz as jviz
from raft_optical_flow_tpu_torch.data.cv import hsv_to_rgb_u8, resize_linear, rgb_to_hsv_u8
from raft_optical_flow_tpu_torch.utils import flow_viz

CHUNKS = 16


@pytest.mark.parametrize("chunk", range(2))
def test_rgb_to_hsv_equals_cv2_on_every_color(chunk):
    half = 1 << 23
    n = half // CHUNKS
    for c in range(CHUNKS):
        code = np.arange(chunk * half + c * n, chunk * half + (c + 1) * n, dtype=np.uint32)
        rgb = np.stack([code >> 16, (code >> 8) & 255, code & 255], -1).astype(np.uint8)
        rgb = rgb.reshape(-1, 1024, 3)
        assert np.array_equal(rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 16, 45])
def test_hsv_to_rgb_equals_cv2_on_every_triple(width):
    """cv2 converts a row's first W // 32 * 32 pixels with vector code and
    the rest with scalar code, which rounds otherwise: rows of 256 pixels
    take the first path only, rows of 16 the second only, rows of 45 both."""
    s, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for h in range(0, 180, 12):
        hsv = np.stack([np.broadcast_to(np.arange(h, h + 12)[:, None, None], (12, 256, 256)),
                        np.broadcast_to(s, (12, 256, 256)), np.broadcast_to(v, (12, 256, 256))],
                       -1).astype(np.uint8).reshape(-1, 3)
        if width == 45:  # a sample of the triples, in a row layout with both paths
            hsv = hsv[np.random.RandomState(h).permutation(len(hsv))[: 45 * 1024]]
        hsv = hsv.reshape(-1, width, 3)
        assert np.array_equal(hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
        if width == 45:  # RGB -> HSV is integer code in both of cv2's paths
            rgb = np.ascontiguousarray(hsv[..., ::-1])
            assert np.array_equal(rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def _scales(rng, n, lo, hi, stretch):
    for _ in range(n):
        s = 2 ** rng.uniform(lo, hi)
        if stretch:
            yield s * 2 ** rng.uniform(-0.2, 0.2), s * 2 ** rng.uniform(-0.2, 0.2)
        else:
            yield s, s


# fetch_dataset's (min_scale, max_scale) per stage, and a frame size of it
STAGES = {"chairs": (-0.1, 1.0, (384, 512)), "things": (-0.4, 0.8, (540, 960)),
          "sintel": (-0.2, 0.6, (436, 1024)), "kitti": (-0.2, 0.4, (375, 1242))}


@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("stretch", [False, True])
def test_resize_equals_cv2_at_the_augmentors_scales(stage, stretch):
    lo, hi, (H, W) = STAGES[stage]
    rng = np.random.RandomState(sorted(STAGES).index(stage) + 10 * stretch)
    # a quarter-size frame (the same fractional positions at a tenth of the cost),
    # smooth and noisy content
    h, w = H // 4, W // 4
    ramp = np.add.outer(np.arange(h), np.arange(w))[..., None] * [1, 2, 3]
    img = ((ramp + rng.randint(0, 64, (h, w, 3))) % 256).astype(np.uint8)
    flow = rng.uniform(-20, 20, (h, w, 2)).astype(np.float32)
    flow3 = rng.uniform(-20, 20, (h, w, 3)).astype(np.float32)
    floor = (96 + 8) / h  # the min-scale floor of a crop
    for fx, fy in list(_scales(rng, 4, lo, hi, stretch)) + [(max(floor, 0.5), max(floor, 0.5))]:
        ref = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        assert np.array_equal(resize_linear(img, fx, fy), ref), (fx, fy)
        ref = cv2.resize(flow, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        got = resize_linear(flow, fx, fy)
        assert got.dtype == np.float32 and np.array_equal(got, ref), (fx, fy)
        ref = cv2.resize(flow3, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        got = resize_linear(flow3, fx, fy)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (3, 200, 4), (200, 3, 2)])
def test_resize_equals_cv2_on_small_and_thin_frames(shape):
    rng = np.random.RandomState(len(shape))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    # (1.001, 0.999): the output has the input's size, which cv2 copies
    for fx, fy in ((1.7, 0.6), (0.8, 2.3), (3.0, 1.0), (1.001, 0.999)):
        ref = cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, fx, fy)
        assert np.array_equal(got.reshape(ref.shape), ref)


def test_flow_viz_equals_the_jax_package():
    rng = np.random.RandomState(8)
    flow = rng.uniform(-12, 12, (31, 45, 2)).astype(np.float32)
    assert np.array_equal(flow_viz.flow_to_image(flow), jviz.flow_to_image(flow))
    assert np.array_equal(flow_viz.flow_to_image(flow, clip_flow=5.0, convert_to_bgr=True),
                          jviz.flow_to_image(flow, clip_flow=5.0, convert_to_bgr=True))
    assert np.array_equal(flow_viz.make_colorwheel(), jviz.make_colorwheel())
    assert np.array_equal(flow_viz.flow_to_rgb_hsv(flow), jviz.flow_to_rgb_hsv(flow))
