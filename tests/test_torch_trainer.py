"""The port's trainer, checkpoints, data and CLI on the CPU.

  - Resume: two steps, save, resume, one more step equals three straight
    steps exactly (the CPU is deterministic; the step generator's state is
    part of the checkpoint, exercised by input noise and dropout).
  - The exported `.npz` loads with the JAX package's `load_flax_checkpoint`
    and gives the same test-mode flow in the JAX model (1e-4, the fp32
    test-mode bar), and a RAFT-standard export has exactly the variable tree
    of a JAX `init`.
  - Synthetic data and the loader yield exactly the JAX package's batches
    (pure numpy on both sides; the JAX dataset is handed the same frames).
  - The CLI trains two steps in a subprocess and writes its checkpoints.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_optical_flow_tpu.data.synthetic as jax_synthetic
from raft_optical_flow_tpu.data.pipeline import FlowDataLoader as JaxFlowDataLoader
from raft_optical_flow_tpu.models import RAFT as JaxRAFT
from raft_optical_flow_tpu.models import RAFTConfig as JaxRAFTConfig
from raft_optical_flow_tpu.utils.torch_convert import load_flax_checkpoint as jax_load
from raft_optical_flow_tpu_torch.cli import train_raft
from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader, prefetch_to_device
from raft_optical_flow_tpu_torch.data.synthetic import (
    SyntheticFlowDataset,
    default_frames,
    warped_pair_batches,
)
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.train.configs import MIXED_CURRICULUM, STANDARD_CURRICULUM, StageConfig
from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer
from raft_optical_flow_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    best_checkpoint_metric,
    latest_tag,
)
from raft_optical_flow_tpu_torch.utils.weights import state_dict_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stage(**kw):
    base = dict(name="t", stage="chairs", num_steps=3, batch_size=2, lr=1e-4,
                image_size=(32, 48), small=True, iters=2, add_noise=True, val_freq=2)
    base.update(kw)
    return StageConfig(**base)


def _trainer(tmp, **kw):
    stage = _stage(**kw)
    config = RAFTConfig(small=True, dropout=0.2)
    return RAFTTrainer(stage, config=config, checkpoint_dir=str(tmp), device="cpu")


def _loader():
    return FlowDataLoader(SyntheticFlowDataset(crop=(32, 48), length=16), batch_size=2,
                          num_workers=2, seed=5)


def test_resume_equals_straight_run(tmp_path):
    straight = _trainer(tmp_path / "a")
    straight.run(_loader(), num_steps=3)
    first = _trainer(tmp_path / "b")
    first.run(_loader(), num_steps=2)
    assert latest_tag(str(tmp_path / "b" / "t_state")) == "latest"
    resumed = _trainer(tmp_path / "b")
    resumed.run(_loader(), num_steps=3, resume=True)
    assert straight.state.step == resumed.state.step == 3
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    fresh = _trainer(tmp_path / "c").model.state_dict()
    assert not all(torch.equal(a[k], fresh[k]) for k in a)
    assert resumed.state.optimizer.param_groups[0]["count"] == 3
    # val_freq=2: a periodic weights file and a periodic full state at step 2
    assert os.path.exists(tmp_path / "b" / "t_2.npz")
    assert os.path.exists(tmp_path / "b" / "t_state" / "step_00000002.pt")

    # the exported weights run in the JAX model and give the port's flow
    path = resumed.save_checkpoint("export")
    variables = jax.tree.map(jnp.asarray, jax_load(path))
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    i1 = g["image1"][:64, :96].astype(np.float32)[None]
    i2 = g["image2"][:64, :96].astype(np.float32)[None]
    _, ref = jax.jit(lambda v, a, b: JaxRAFT(JaxRAFTConfig(small=True)).apply(
        v, a, b, iters=3, test_mode=True))(variables, jnp.asarray(i1), jnp.asarray(i2))
    _, up = resumed.model(torch.from_numpy(i1), torch.from_numpy(i2), iters=3)
    assert np.abs(up.numpy() - np.asarray(ref)).max() <= 1e-4


def test_standard_export_has_the_jax_variable_tree():
    model = RAFT(RAFTConfig(), device="cpu")
    exported = state_dict_to_flax(model.state_dict())
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: JaxRAFT(JaxRAFTConfig()).init(k, img, img, iters=1,
                                                                    test_mode=True),
                            jax.random.PRNGKey(0))

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v.shape)

    assert dict(flat(exported)) == dict(flat(jax.tree.map(lambda x: x, dict(shapes))))


def test_warm_start_takes_matching_entries_only():
    ckpt = jax_load(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    del ckpt["params"]["fnet"]["conv1"]  # missing: stays at its init
    ckpt["params"]["cnet"]["conv2"]["kernel"] = np.zeros((1, 1, 96, 7), np.float32)  # shape mismatch
    tr = RAFTTrainer(_stage(), restore_variables=ckpt, device="cpu")
    init = RAFT(RAFTConfig(small=True), device="cpu",
                generator=torch.Generator().manual_seed(1234)).state_dict()
    sd = tr.model.state_dict()
    assert torch.equal(sd["fnet.conv1.weight"], init["fnet.conv1.weight"])
    assert torch.equal(sd["cnet.conv2.weight"], init["cnet.conv2.weight"])
    want = torch.from_numpy(ckpt["params"]["fnet"]["conv2"]["kernel"].transpose(3, 2, 0, 1).copy())
    assert torch.equal(sd["fnet.conv2.weight"], want)


def test_checkpoint_manager_policy(tmp_path):
    tr = _trainer(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "s"), keep_every=10)
    assert mgr.restore_latest(tr.state) == (tr.state, False)
    mgr.save(tr.state, 5, metric=2.0)
    mgr.save(tr.state, 10, metric=3.0)
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == ["best.json", "best.pt", "latest.pt", "step_00000010.pt"]
    assert CheckpointManager(str(tmp_path / "s")).best_metric == 2.0
    assert best_checkpoint_metric({"clean": 1.5, "final": 2.5, "clean_1px": 0.1}) == 1.5
    assert best_checkpoint_metric({"kitti-f1": 20.0}) is None


def test_curricula_are_the_reference_schedules():
    chairs = STANDARD_CURRICULUM[0]
    assert (chairs.batch_size, chairs.lr, chairs.image_size, chairs.freeze_bn) == (
        10, 4e-4, (368, 496), False)
    assert [s.stage for s in MIXED_CURRICULUM] == ["chairs", "things", "sintel", "kitti"]
    assert all(s.mixed_precision for s in MIXED_CURRICULUM)
    assert MIXED_CURRICULUM[1].restore_from == "raft-chairs-mixed"


@pytest.fixture
def jax_frames(monkeypatch):
    frames = default_frames()
    monkeypatch.setattr(jax_synthetic, "_load_frames", lambda _dir: frames)
    return frames


def test_synthetic_loader_matches_jax(jax_frames):
    ours = FlowDataLoader(SyntheticFlowDataset(crop=(64, 96), length=10), batch_size=3,
                          num_workers=2, seed=7)
    theirs = JaxFlowDataLoader(jax_synthetic.SyntheticFlowDataset(crop=(64, 96), length=10,
                                                                  frames_dir="unused"),
                               batch_size=3, num_workers=2, seed=7)
    for skip in (0, 4):
        a, b = ours.epochs(skip_batches=skip), theirs.epochs(skip_batches=skip)
        for _ in range(4):  # 3 batches per epoch: crosses an epoch boundary
            x, y = next(a), next(b)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == np.float32 and np.array_equal(x[k], y[k]), k
        a.close()
        b.close()


def test_warped_pair_batches_match_jax(jax_frames):
    a = warped_pair_batches(2, crop=(48, 64), seed=3)
    b = jax_synthetic.warped_pair_batches(2, crop=(48, 64), seed=3, frames_dir="unused")
    for _ in range(2):
        x, y = next(a), next(b)
        assert all(np.array_equal(x[k], y[k]) for k in y)


def test_prefetch_to_device_feeds_and_stops():
    batches = ({"image1": np.full((1, 2), i, np.float32)} for i in range(100))
    feed = prefetch_to_device(batches, size=2, device="cpu")
    got = [next(feed)["image1"] for _ in range(3)]
    assert [float(t[0, 0]) for t in got] == [0.0, 1.0, 2.0] and isinstance(got[0], torch.Tensor)
    feed.close()

    def broken():
        yield {"image1": np.zeros(1)}
        raise OSError("decode failed")

    feed = prefetch_to_device(broken(), device="cpu")
    next(feed)
    with pytest.raises(OSError, match="decode failed"):
        next(feed)


@pytest.mark.parametrize("extra", [[], ["--validation", "chairs"], ["--data_root", "datasets"]])
def test_cli_refuses_unported_paths(extra):
    args = ["--stage", "chairs"] + (["--synthetic"] if extra else []) + extra
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_raft.main(args)


def test_cli_rejects_a_crop_the_frames_cannot_hold(tmp_path):
    args = ["--stage", "chairs", "--synthetic", "--device", "cpu", "--image_size", "368", "496",
            "--checkpoint_dir", str(tmp_path)]
    with pytest.raises(ValueError, match="at most 168x296"):
        train_raft.main(args)
    assert not os.listdir(tmp_path)  # refused before the trainer was built


def test_cli_trains_with_alternate_corr(tmp_path):
    """`--alternate_corr` trains through the on-demand correlation: two
    steps on the CPU, then the checkpoints."""
    args = ["--stage", "chairs", "--synthetic", "--small", "--alternate_corr", "--device", "cpu",
            "--num_steps", "2", "--image_size", "64", "96", "--batch_size", "2", "--iters", "2",
            "--num_workers", "1", "--checkpoint_dir", str(tmp_path)]
    assert train_raft.parse_args(args).alternate_corr
    train_raft.main(args)
    assert os.path.exists(tmp_path / "raft.npz")
    assert os.path.exists(tmp_path / "raft_state" / "latest.pt")


def test_cli_trains_and_writes_checkpoints(tmp_path):
    cmd = [sys.executable, "-m", "raft_optical_flow_tpu_torch.cli.train_raft",
           "--stage", "chairs", "--synthetic", "--small", "--device", "cpu",
           "--num_steps", "2", "--image_size", "64", "96", "--batch_size", "2",
           "--iters", "2", "--num_workers", "2", "--checkpoint_dir", str(tmp_path)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(tmp_path / "raft.npz")
    assert os.path.exists(tmp_path / "raft_state" / "latest.pt")
    assert np.load(tmp_path / "raft.npz")["params/fnet/conv1/kernel"].shape == (7, 7, 3, 32)
