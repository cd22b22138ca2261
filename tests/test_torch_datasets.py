"""The port's augmentors, datasets and loader against the JAX package's.

Both packages draw from the same np.random.Generator in the same order, and
the port's resize and HSV conversions equal cv2's (tests/test_torch_cv.py),
so the samples are held equal bit for bit: images, flows and valid masks,
directly through the augmentors and through each dataset class and
`FlowDataLoader` on trees written to tmp_path.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

import torch_data_trees as trees
from raft_optical_flow_tpu.data import augmentor as jaug
from raft_optical_flow_tpu.data import datasets as jds
from raft_optical_flow_tpu.data import frame_utils as jfu
from raft_optical_flow_tpu.data.pipeline import FlowDataLoader as JaxFlowDataLoader
from raft_optical_flow_tpu_torch.data import augmentor as aug
from raft_optical_flow_tpu_torch.data import datasets as ds
from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader
from test_data_layer import _make_mini_sintel


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        else:
            assert x == y


def _frames(seed, hw=(80, 120)):
    r = np.random.RandomState(seed)
    ramp = np.add.outer(np.arange(hw[0]), np.arange(hw[1]))[..., None] * [2, 1, 3]
    img1 = ((ramp + r.randint(0, 60, (*hw, 3))) % 256).astype(np.uint8)
    img2 = ((ramp + r.randint(0, 60, (*hw, 3))) % 256).astype(np.uint8)
    flow = r.uniform(-8, 8, (*hw, 2)).astype(np.float32)
    valid = (r.uniform(0, 1, hw) > 0.4).astype(np.float32)
    return img1, img2, flow, valid


@pytest.mark.parametrize("do_flip", [True, False])
def test_flow_augmentor_samples_equal(do_flip):
    kw = {"crop_size": (48, 64), "min_scale": -0.2, "max_scale": 0.6, "do_flip": do_flip}
    ours, theirs = aug.FlowAugmentor(**kw), jaug.FlowAugmentor(**kw)
    for seed in range(12):
        img1, img2, flow, _ = _frames(seed)
        a = ours(img1, img2, flow, np.random.default_rng(seed))
        b = theirs(img1, img2, flow, np.random.default_rng(seed))
        _equal(a, b)


@pytest.mark.parametrize("do_flip", [False, True])
def test_sparse_flow_augmentor_samples_equal(do_flip):
    kw = {"crop_size": (48, 64), "min_scale": -0.2, "max_scale": 0.4, "do_flip": do_flip}
    ours, theirs = aug.SparseFlowAugmentor(**kw), jaug.SparseFlowAugmentor(**kw)
    for seed in range(12):
        img1, img2, flow, valid = _frames(100 + seed, (60, 123))
        a = ours(img1, img2, flow, valid, np.random.default_rng(seed))
        b = theirs(img1, img2, flow, valid, np.random.default_rng(seed))
        _equal(a, b)
    f, v = aug.SparseFlowAugmentor.resize_sparse_flow_map(flow, valid, 1.3, 0.9)
    _equal((f, v), jaug.SparseFlowAugmentor.resize_sparse_flow_map(flow, valid, 1.3, 0.9))


def test_color_jitter_equal():
    img = _frames(7, (33, 77))[0]
    for seed in range(8):
        a = aug.NumpyColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)(img, np.random.default_rng(seed))
        b = jaug.NumpyColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14)(img, np.random.default_rng(seed))
        assert np.array_equal(a, b)


def _index(d):
    return (type(d).__name__, d.image_list, d.flow_list, d.extra_info, d.is_test, d.sparse,
            len(d))


def _samples_equal(ours, theirs, indices):
    for i in indices:
        got = ours.__getitem__(i, rng=np.random.default_rng(i))
        if ours.is_test:  # the JAX package reads a flow there and fails: read the frames
            p1, p2 = theirs.image_list[i]
            ref = (np.array(jfu.read_gen(p1)).astype(np.float32),
                   np.array(jfu.read_gen(p2)).astype(np.float32), theirs.extra_info[i])
        else:
            ref = theirs.__getitem__(i, rng=np.random.default_rng(i))
        _equal(got, ref)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    sintel = str(base / "Sintel")
    _make_mini_sintel(sintel, scenes=("alley_9", "ambush_2"), frames=3)
    return {"sintel": sintel, "chairs": trees.make_chairs(str(base)),
            "things": trees.make_things(str(base / "Things")),
            "kitti": trees.make_kitti(str(base / "KITTI")),
            "hd1k": trees.make_hd1k(str(base / "HD1k"))}


AUG = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4, "do_flip": True}


@pytest.mark.parametrize("name", ["sintel", "sintel_val", "sintel_eval", "chairs", "chairs_val",
                                  "things", "kitti", "kitti_test", "hd1k"])
def test_dataset_index_lists_and_samples_equal(roots, name):
    r = roots
    make = {
        "sintel": lambda m: m.MpiSintel(AUG, root=r["sintel"], dstype="final", repeat=2),
        "sintel_val": lambda m: m.MpiSintelVal(None, root=r["sintel"], dstype="clean"),
        "sintel_eval": lambda m: m.MpiSintel(None, split="training", root=r["sintel"]),
        "chairs": lambda m: m.FlyingChairs(AUG, root=r["chairs"]),
        "chairs_val": lambda m: m.FlyingChairs(None, split="validation", root=r["chairs"]),
        "things": lambda m: m.FlyingThings3D(AUG, root=r["things"]),
        "kitti": lambda m: m.KITTI(dict(AUG, do_flip=False), root=r["kitti"]),
        "kitti_test": lambda m: m.KITTI(None, split="testing", root=r["kitti"]),
        "hd1k": lambda m: m.HD1K(dict(AUG, do_flip=False), root=r["hd1k"]),
    }[name]
    ours, theirs = make(ds), make(jds)
    assert len(ours) > 0
    _equal(_index(ours), _index(theirs))
    _samples_equal(ours, theirs, range(min(len(ours), 4)))


def test_preload_cache_and_combinations(roots):
    ours = ds.MpiSintel(None, root=roots["sintel"], dstype="clean", preload_data=True)
    theirs = jds.MpiSintel(None, root=roots["sintel"], dstype="clean", preload_data=True)
    assert ours.get_cache_info() == theirs.get_cache_info()
    assert ours.get_cache_info()["cached"] == 4
    _samples_equal(ours, theirs, range(4))
    ours.clear_cache()
    assert ours.get_cache_info()["cached"] == 0
    a = 3 * ds.MpiSintel(None, root=roots["sintel"]) + 2 * ds.FlyingChairs(None, root=roots["chairs"])
    b = 3 * jds.MpiSintel(None, root=roots["sintel"]) + 2 * jds.FlyingChairs(None, root=roots["chairs"])
    assert len(a) == len(b) == 3 * 20 + 2 * 4
    _samples_equal(a, b, [0, 19, 59, 60, 67])


@pytest.mark.parametrize("stage", ["chairs", "things", "sintel", "kitti"])
def test_fetch_dataset_equal(roots, stage):
    ours = ds.fetch_dataset(stage, (32, 48), roots={stage: roots[stage]})
    theirs = jds.fetch_dataset(stage, (32, 48), roots={stage: roots[stage]})
    assert len(ours) == len(theirs) > 0
    parts = getattr(ours, "datasets", [ours])
    for o, t in zip(parts, getattr(theirs, "datasets", [theirs])):
        _equal(_index(o), _index(t))
        assert vars(o.augmentor).keys() == vars(t.augmentor).keys()
        for k, v in vars(o.augmentor).items():
            if k != "photo_aug":
                assert v == getattr(t.augmentor, k), k
    assert getattr(ours, "multipliers", None) == getattr(theirs, "multipliers", None)
    _samples_equal(ours, theirs, [0, len(ours) - 1])
    with pytest.raises(ValueError, match="unknown stage"):
        ds.fetch_dataset("nope", (32, 48))


def test_loader_batches_equal_the_jax_loader(roots):
    ours = FlowDataLoader(ds.fetch_dataset("chairs", (32, 48), roots={"chairs": roots["chairs"]}),
                          batch_size=2, num_workers=2, seed=5)
    theirs = JaxFlowDataLoader(
        jds.fetch_dataset("chairs", (32, 48), roots={"chairs": roots["chairs"]}),
        batch_size=2, num_workers=2, seed=5)
    a, b, again = ours.epochs(), theirs.epochs(), ours.epochs()
    for _ in range(3):  # two epochs of the four training pairs, and into the third
        x, y, z = next(a), next(b), next(again)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].shape[0] == 2 and np.array_equal(x[k], y[k]) and np.array_equal(x[k], z[k])
    skipped = next(ours.epochs(skip_batches=2))
    assert np.array_equal(skipped["flow"], x["flow"])
