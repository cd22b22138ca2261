"""The port's validators, warm start and submission writers
(`eval/evaluate.py`) against the JAX package's.

With a fake forward (a constant flow, the cases of tests/test_eval.py) the
metrics are equal; `forward_interpolate` is equal; the submission files
decode equal. One integration run holds RAFT-small from the checkpoint
(64x96, 4 iterations) through the port's `validate_sintel` against the JAX
one on the same on-disk tree (real frames: `torch_data_trees.real_frames`):
EPE within 1e-5, each px share within one pixel's weight.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import torch_data_trees as trees

from raft_optical_flow_tpu.data import datasets as jds
from raft_optical_flow_tpu.data import frame_utils as jfu
from raft_optical_flow_tpu.eval import evaluate as JE
from raft_optical_flow_tpu.models.raft import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint
from raft_optical_flow_tpu_torch.data import datasets as ds
from raft_optical_flow_tpu_torch.data import frame_utils as fu
from raft_optical_flow_tpu_torch.eval import evaluate as E
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from test_data_layer import _make_mini_sintel

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "raft_small.npz")


def _fake_fwd(value):
    def fwd(i1, i2, flow_init=None):
        N, H, W, _ = i1.shape
        return (torch.full((N, H // 8, W // 8, 2), value / 8.0),
                torch.full((N, H, W, 2), float(value)))

    fwd.device = torch.device("cpu")
    return fwd


def _jax_fake_fwd(value):
    def fwd(i1, i2, flow_init=None):
        N, H, W, _ = i1.shape
        return (jnp.full((N, H // 8, W // 8, 2), value / 8.0, jnp.float32),
                jnp.full((N, H, W, 2), value, jnp.float32))

    return fwd


def _samples(n=3, H=40, W=60, seed=0, sparse=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img1 = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        img2 = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        flow = rng.uniform(-4, 4, (H, W, 2)).astype(np.float32)
        valid = (rng.uniform(0, 1, (H, W)) > 0.5 if sparse else np.ones((H, W))).astype(np.float32)
        out.append((img1, img2, flow, valid))
    return out


@pytest.mark.parametrize("value", [1.5, 2.0, -3.0])
def test_validators_with_a_fake_forward_equal_the_jax_ones(value):
    s = _samples()
    assert E.validate_sintel(_fake_fwd(value), s, "clean") == JE.validate_sintel(
        _jax_fake_fwd(value), s, "clean")
    assert E.validate_chairs(_fake_fwd(value), s) == JE.validate_chairs(_jax_fake_fwd(value), s)
    k = _samples(H=37, W=70, sparse=True)
    assert E.validate_kitti(_fake_fwd(value), k) == JE.validate_kitti(_jax_fake_fwd(value), k)
    # tests/test_eval.py's exact cases
    const = [(a, b, np.full_like(f, 1.5), v) for a, b, f, v in s]
    res = E.validate_sintel(_fake_fwd(2.0), const, "clean")
    np.testing.assert_allclose(res["clean"], np.sqrt(2 * 0.5 ** 2), rtol=1e-6)
    assert res["clean_1px"] == 1.0
    assert E.validate_chairs(_fake_fwd(1.5), const)["chairs"] == 0.0
    assert E.validate_kitti(_fake_fwd(1.5), const) == {"kitti-epe": 0.0, "kitti-f1": 0.0}


def test_forward_interpolate_equals_the_jax_one():
    rng = np.random.RandomState(1)
    for flow in (rng.uniform(-3, 3, (12, 16, 2)).astype(np.float32),
                 np.full((12, 16, 2), 2.0, np.float32), np.zeros((12, 16, 2), np.float32),
                 np.full((6, 8, 2), 100.0, np.float32)):
        got, ref = E.forward_interpolate(flow), JE.forward_interpolate(flow)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_submission_files_equal_the_jax_ones(tmp_path):
    frames = [(np.zeros((40, 60, 3), np.float32), np.zeros((40, 60, 3), np.float32), i)
              for i in range(2)]
    E.create_sintel_submission(_fake_fwd(1.0), [("seq_a", frames)],
                               output_path=str(tmp_path / "ours"), warm_start=True)
    JE.create_sintel_submission(_jax_fake_fwd(1.0), [("seq_a", frames)],
                                output_path=str(tmp_path / "theirs"), warm_start=True)
    for i in (1, 2):
        name = os.path.join("seq_a", f"frame{i:04d}.flo")
        assert open(tmp_path / "ours" / name, "rb").read() == \
            open(tmp_path / "theirs" / name, "rb").read()
    kf = [(np.zeros((37, 61, 3), np.float32), np.zeros((37, 61, 3), np.float32), "000000_10.png")]
    E.create_kitti_submission(_fake_fwd(-1.25), kf, output_path=str(tmp_path / "k_ours"))
    JE.create_kitti_submission(_jax_fake_fwd(-1.25), kf, output_path=str(tmp_path / "k_theirs"))
    a = fu.read_flow_kitti(str(tmp_path / "k_ours" / "000000_10.png"))
    b = jfu.read_flow_kitti(str(tmp_path / "k_theirs" / "000000_10.png"))
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    np.testing.assert_array_equal(a[0], -1.25)


def test_warm_start_feeds_flow_init(tmp_path):
    seen = []

    def fwd(i1, i2, flow_init=None):
        seen.append(None if flow_init is None else tuple(flow_init.shape))
        return _fake_fwd(1.0)(i1, i2)

    fwd.device = torch.device("cpu")
    frames = [(np.zeros((40, 60, 3), np.float32), np.zeros((40, 60, 3), np.float32), i)
              for i in range(3)]
    E.create_sintel_submission(fwd, [("s", frames)], output_path=str(tmp_path), warm_start=True)
    assert seen == [None, (1, 5, 8, 2), (1, 5, 8, 2)]


def test_validate_sintel_with_raft_small_equals_jax(tmp_path):
    root = str(tmp_path / "sintel")
    _make_mini_sintel(root, scenes=("ambush_2",), frames=3, hw=(64, 96))
    trees.put_real_frames(root, "ambush_2")
    ours = ds.MpiSintelVal(None, root=root, dstype="clean")
    theirs = jds.MpiSintelVal(None, root=root, dstype="clean")
    samples = [ours.__getitem__(i) for i in range(len(ours))]
    assert len(samples) == 2
    for a, b in zip(samples, [theirs.__getitem__(i) for i in range(len(theirs))]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    fwd = E.make_raft_forward(RAFTConfig(small=True), load_flax_npz(CKPT), iters=4, device="cpu")
    res = E.validate_sintel(fwd, samples, "clean")
    variables = jax.tree.map(jnp.asarray, load_flax_checkpoint(CKPT))
    ref = JE.validate_sintel(JE.make_raft_forward(JaxRAFTConfig(small=True), variables, iters=4),
                             samples, "clean")
    assert res.keys() == ref.keys()
    assert abs(res["clean"] - ref["clean"]) <= 1e-5
    one_pixel = 1.0 / (len(samples) * 64 * 96)
    for k in ("clean_1px", "clean_3px", "clean_5px"):
        assert abs(res[k] - ref[k]) <= one_pixel + 1e-12, k
    # the same through a model object, as the trainer's val_fn passes it
    model = RAFT(RAFTConfig(small=True), device="cpu")
    model.load_state_dict(load_flax_npz(CKPT))
    assert E.validate_sintel(E.make_raft_forward(None, model, iters=4), samples, "clean") == res
