"""16-bit PNG frames: the port's `read_gen` against the JAX package's.

The JAX `read_gen` returns PIL's image, which keeps the high byte of each
sample of a 16-bit RGB, RGBA or grey+alpha PNG (uint8; grey+alpha opened as
RGBA) and all 16 bits of a grey one (uint16). The port's `read_gen` gives
the same arrays, and so the same `FlowDataset` samples; `read_png` and
`read_flow_kitti` keep all 16 bits, as the JAX package's cv2 reader does.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

import torch_jpeg_fixtures as fx
from raft_optical_flow_tpu.data import datasets as jds
from raft_optical_flow_tpu.data import frame_utils as jfu
from raft_optical_flow_tpu_torch.data import datasets as ds
from raft_optical_flow_tpu_torch.data import frame_utils as fu

KINDS = ["rgb16", "rgba16", "ga16", "grey16"]


def _write(path, kind, hw, seed):
    color, depth = fx.PNG_KINDS[kind]
    samples = fx.png_samples(kind, hw, seed)
    with open(path, "wb") as f:
        f.write(fx.png_bytes(samples, color, depth, interlace=False))
    return samples


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_read_gen_on_16_bit_pngs_equals_the_jax_reader(tmp_path, kind):
    path = str(tmp_path / f"{kind}.png")
    samples = _write(path, kind, (23, 31), seed=5)
    ref = np.array(jfu.read_gen(path))
    got = fu.read_gen(path)
    _same(got, ref)
    assert got.dtype == (np.uint16 if kind == "grey16" else np.uint8)
    # read_png keeps every bit (the low bytes differ from the high ones here)
    _same(fu.read_png(path), samples[..., 0] if kind == "grey16" else samples)
    assert (samples & 255).any()


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_flow_dataset_on_16_bit_frames_equals_jax(tmp_path, kind, augment):
    hw = (48, 64)
    frames = []
    for i in range(2):
        frames.append(str(tmp_path / f"frame_{i}.png"))
        _write(frames[-1], kind, hw, seed=i)
    flo = str(tmp_path / "flow.flo")
    fu.write_flow(flo, np.random.RandomState(3).uniform(-5, 5, (*hw, 2)).astype(np.float32))
    aug = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4} if augment else None
    ours, theirs = ds.FlowDataset(aug), jds.FlowDataset(aug)
    for d in (ours, theirs):
        d.image_list, d.flow_list = [frames], [flo]
    a = ours.__getitem__(0, rng=np.random.default_rng(7))
    b = theirs.__getitem__(0, rng=np.random.default_rng(7))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        _same(x, y)


def test_read_flow_kitti_keeps_16_bits(tmp_path):
    flow = np.round(np.random.RandomState(9).uniform(-40, 40, (15, 27, 2)) * 64) / 64
    valid = np.random.RandomState(10).uniform(0, 1, (15, 27)) > 0.5
    path = str(tmp_path / "kitti.png")
    fu.write_flow_kitti(path, flow, valid)
    f, v = fu.read_flow_kitti(path)
    jf, jv = jfu.read_flow_kitti(path)  # cv2, all 16 bits
    _same(f, jf)
    _same(v, jv)
    assert np.array_equal(f, flow.astype(np.float32))
    raw = fu.read_png(path)
    assert raw.dtype == np.uint16 and (raw[..., :2] & 255).any()
