"""The port's inference and training CLIs on dataset trees, on the CPU
(`--device cpu`): `cli/evaluate.py` on Sintel, KITTI, Chairs and synthetic
sets, `cli/demo.py` (each of its four architectures), `cli/train_raft.py
--stage chairs --data_root ... --validation chairs` and `cli/train_flow.py
--stage sintel --data_root ...`, one step each.

Each evaluate run is held against the port's validators called directly on
the same dataset (the CLI adds only the wiring); the demo's PNGs are decoded
by PIL and by the port.
"""

import os

import numpy as np
import pytest
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import torch_data_trees as trees
from raft_optical_flow_tpu_torch.cli import demo, evaluate, train_flow, train_raft
from raft_optical_flow_tpu_torch.data import datasets as ds
from raft_optical_flow_tpu_torch.data import frame_utils as fu
from raft_optical_flow_tpu_torch.eval import evaluate as E
from raft_optical_flow_tpu_torch.models import RAFTConfig
from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz
from test_data_layer import _make_mini_sintel

CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "raft_small.npz")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
LFN3 = os.path.join(GOLDENS, "lfn3_standard_params.npz")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    sintel = str(base / "Sintel")
    _make_mini_sintel(sintel, scenes=("ambush_2", "market_2"), frames=2, hw=(48, 64))
    return {"sintel": sintel, "chairs": trees.make_chairs(str(base), hw=(80, 112)),
            "kitti": trees.make_kitti(str(base / "KITTI"))}


def _direct(name, root, iters):
    fwd = E.make_raft_forward(RAFTConfig(small=True), load_flax_npz(CKPT), iters, device="cpu")
    samples = evaluate._eval_samples
    if name == "chairs":
        return E.validate_chairs(fwd, samples(ds.FlyingChairs(None, "validation", root=root)))
    if name == "kitti":
        return E.validate_kitti(fwd, samples(ds.KITTI(None, root=root)))
    out = {}
    for dstype in ("clean", "final"):
        out.update(E.validate_sintel(fwd, samples(ds.MpiSintelVal(None, root=root,
                                                                   dstype=dstype)), dstype))
    return out


@pytest.mark.parametrize("name", ["sintel", "kitti", "chairs"])
def test_evaluate_cli_on_a_tree(roots, name):
    res = evaluate.main(["--model", CKPT, "--small", "--iters", "2", "--device", "cpu",
                         "--dataset", name, f"--{name}_root", roots[name]])
    assert res and all(np.isfinite(v) for v in res.values())
    assert res == _direct(name, roots[name], 2)


def test_evaluate_cli_synthetic():
    res = evaluate.main(["--model", CKPT, "--small", "--iters", "2", "--device", "cpu",
                         "--dataset", "synthetic", "--synthetic_size", "48", "64",
                         "--synthetic_samples", "2"])
    assert set(res) == {"synthetic", "synthetic_1px", "synthetic_3px", "synthetic_5px"}
    assert all(np.isfinite(v) for v in res.values())


@pytest.mark.parametrize("arch,model", [
    ("raft", CKPT), ("liteflownet3", LFN3),
    ("simple_flow", os.path.join(GOLDENS, "simple_flow_params.npz")),
    ("ifnet", os.path.join(GOLDENS, "ifnet_params.npz"))])
def test_demo_cli_writes_readable_pngs(tmp_path, arch, model):
    out = str(tmp_path / "demo")
    paths = demo.main(["--model", model, "--arch", arch, "--small", "--iters", "2",
                       "--synthetic", "--out", out, "--device", "cpu"])
    assert len(paths) == 1
    img = fu.read_png(paths[0])
    assert img.shape == (512, 256, 3) and img.dtype == np.uint8
    assert np.array_equal(np.array(Image.open(paths[0])), img)
    first = fu.read_png(os.path.join(out, "demo_images", "img1.png"))
    assert np.array_equal(img[:256], first)


def test_train_raft_cli_chairs_stage_with_validation(roots, tmp_path, capsys):
    trainer = train_raft.main([
        "--stage", "chairs", "--data_root", roots["chairs"], "--validation", "chairs",
        "--small", "--device", "cpu", "--num_steps", "1", "--val_freq", "1", "--batch_size", "2",
        "--iters", "2", "--image_size", "64", "96", "--num_workers", "2",
        "--checkpoint_dir", str(tmp_path)])
    assert trainer.state.step == 1
    out = capsys.readouterr().out
    assert "Training with 4 image pairs" in out and "Validation Chairs EPE" in out
    assert os.path.exists(tmp_path / "raft_1.npz") and os.path.exists(tmp_path / "raft.npz")


def test_train_flow_cli_sintel_stage(roots, tmp_path, capsys):
    trainer = train_flow.main([
        "--model", "ifnet", "--stage", "sintel", "--data_root", roots["sintel"],
        "--device", "cpu", "--num_steps", "1", "--batch_size", "1", "--image_size", "32", "48",
        "--num_workers", "1", "--checkpoint_dir", str(tmp_path)])
    assert trainer.state.step == 1
    assert "Training ifnet with 2000 image pairs" in capsys.readouterr().out
