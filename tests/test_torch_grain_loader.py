"""The port's process-worker loader (`data/grain_pipeline.py`) against the
JAX package's.

Each record equals the JAX `_FlowRecordSource(dataset, seed)[i]` bit for bit
(both draw from default_rng((seed, i))); worker processes give grain's
split of the stream (worker w's batches cut from positions w, w + W, ...,
round-robin); each epoch of the stream visits every record once; and the
batches equal the JAX `GrainFlowLoader`'s, record for record and in order,
at num_workers 0 and 2, with and without shuffle.
"""

import hashlib
import itertools

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

import torch_data_trees as trees
from raft_optical_flow_tpu.data import datasets as jds
from raft_optical_flow_tpu.data import grain_pipeline as jgp
from raft_optical_flow_tpu_torch.data import datasets as ds
from raft_optical_flow_tpu_torch.data.grain_pipeline import (
    GrainFlowLoader,
    _FlowRecordSource,
    batch_positions,
    record_stream,
)

AUG = {"crop_size": (32, 48), "min_scale": -0.2, "max_scale": 0.4, "do_flip": True}
SEED = 7


def _datasets(tmp_path, kind):
    """(port, JAX) datasets of one tree: chairs (dense, 6 pairs) or KITTI
    (sparse, 3 pairs of three sizes)."""
    if kind == "chairs":
        root = trees.make_chairs(str(tmp_path), n=6, hw=(48, 64), split=(1,) * 6)
        return ds.FlyingChairs(AUG, root=root), jds.FlyingChairs(AUG, root=root)
    root = trees.make_kitti(str(tmp_path))
    aug = {k: v for k, v in AUG.items() if k != "do_flip"}
    return ds.KITTI(aug, root=root), jds.KITTI(aug, root=root)


def _equal_records(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert np.array_equal(a[k], b[k])


def _records(batches):
    """The records of a list of batches, in stream order."""
    return [{k: v[j] for k, v in b.items()} for b in batches for j in range(len(b["flow"]))]


def _digest(record):
    h = hashlib.sha256()
    for k in sorted(record):
        h.update(np.ascontiguousarray(record[k]).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("kind", ["chairs", "kitti"])
def test_records_equal_the_jax_record_source(tmp_path, kind):
    ours, theirs = _datasets(tmp_path, kind)
    src, jsrc = _FlowRecordSource(ours, SEED), jgp._FlowRecordSource(theirs, SEED)
    assert len(src) == len(jsrc) == len(ours)
    for i in range(len(src)):
        _equal_records(src[i], jsrc[i])
    _equal_records(src[1], src[1])  # a record is the same on every visit
    assert not np.array_equal(src[0]["image1"], _FlowRecordSource(ours, SEED + 1)[0]["image1"])


def test_process_workers_give_the_in_process_batches(tmp_path):
    """Worker processes give grain's split of the stream: worker w's t-th
    batch holds positions w + W * (t * B + m), batches round-robin; in-process
    loading gives consecutive slices."""
    ours, _ = _datasets(tmp_path, "chairs")
    n_batches, bs = 4, 4  # 16 records of 6: the batches cross two epoch boundaries
    got = {}
    for workers in (0, 2):
        it = iter(GrainFlowLoader(ours, bs, num_workers=workers, seed=SEED))
        got[workers] = [next(it) for _ in range(n_batches)]
        it.close()
    src = _FlowRecordSource(ours, SEED)
    stream = list(itertools.islice(record_stream(len(ours), True, SEED), n_batches * bs))
    assert [batch_positions(j, bs, 2) for j in range(4)] == [
        [0, 2, 4, 6], [1, 3, 5, 7], [8, 10, 12, 14], [9, 11, 13, 15]]
    for workers in (0, 2):
        positions = [p for j in range(n_batches) for p in batch_positions(j, bs, workers)]
        assert sorted(positions) == list(range(n_batches * bs))
        for p, record in zip(positions, _records(got[workers])):
            _equal_records(record, src[stream[p]])
        a = got[workers][0]
        assert a["image1"].shape == (bs, *AUG["crop_size"], 3) and a["image1"].dtype == np.float32
    assert not np.array_equal(got[0][1]["image1"], got[2][1]["image1"])


@pytest.mark.parametrize("shuffle", [True, False])
def test_each_epoch_is_a_permutation(tmp_path, shuffle):
    n = 6
    stream = list(itertools.islice(record_stream(n, shuffle, SEED), 4 * n))
    for e in range(4):
        assert sorted(stream[e * n:(e + 1) * n]) == list(range(n))
    if shuffle:  # each epoch its own order
        assert len({tuple(stream[e * n:(e + 1) * n]) for e in range(4)}) > 1
    else:
        assert stream[:n] == list(range(n))
    ours, _ = _datasets(tmp_path, "chairs")
    it = iter(GrainFlowLoader(ours, 4, shuffle=shuffle, num_workers=0, seed=SEED))
    records = _records([next(it) for _ in range(3)])  # two epochs of 6
    src = _FlowRecordSource(ours, SEED)
    want = sorted(_digest(src[i]) for i in range(n))
    for e in range(2):
        assert sorted(_digest(r) for r in records[e * n:(e + 1) * n]) == want


@pytest.mark.parametrize("workers,shuffle", [(0, True), (0, False), (2, True)])
def test_an_epoch_holds_the_jax_loaders_records(tmp_path, workers, shuffle):
    """The port's batches are the JAX loader's (grain's), in order: one grain
    run for each case, two epochs and a bit of 6 records. (Unshuffled at 2
    workers, grain's batch order is held by the committed stream in
    test_torch_grain_order.py: a grain run with workers takes about 12 s.)"""
    pytest.importorskip("grain.python")
    ours, theirs = _datasets(tmp_path, "chairs")
    n_batches = 5  # 15 records: both epoch boundaries fall inside a batch
    it = iter(GrainFlowLoader(ours, 3, shuffle=shuffle, num_workers=workers, seed=SEED))
    jit = iter(jgp.GrainFlowLoader(theirs, 3, shuffle=shuffle, num_workers=workers, seed=SEED))
    mine = [next(it) for _ in range(n_batches)]
    jax_batches = [next(jit) for _ in range(n_batches)]
    it.close()
    jit.close()
    assert [_digest(r) for r in _records(mine)] == [_digest(r) for r in _records(jax_batches)]
    for a, b in zip(mine, jax_batches):
        _equal_records(a, b)
