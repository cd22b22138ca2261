"""The port's copy of grain's `index_shuffle` (`data/index_shuffle.py`) and
the record stream built on it, against grain's C++ `index_shuffle` and its
`IndexSampler`.

Whole epochs for small datasets, a few thousand sampled indices for large
ones (cipher blocks of 16, 18 and 20 bits), at seeds 0, 1234 and 2**32 - 1,
and across epochs whose seed (seed + epoch) % 2**32 wraps.
"""

import itertools

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from raft_optical_flow_tpu_torch.data.grain_pipeline import epoch_order, record_stream
from raft_optical_flow_tpu_torch.data.index_shuffle import (
    block_bits,
    index_shuffle,
    seed_seq_generate,
)

grain_shuffle = pytest.importorskip(
    "grain._src.python.experimental.index_shuffle.python.index_shuffle_module")
SEEDS = (0, 1234, 2**32 - 1)


def _grain(indices, max_index, seed, rounds=4):
    return [grain_shuffle.index_shuffle(int(i), max_index=max_index, seed=seed, rounds=rounds)
            for i in indices]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 3, 10, 12, 640])
def test_whole_epochs_equal_grains(n, seed):
    want = _grain(range(n), n - 1, seed)
    got = index_shuffle(np.arange(n), n - 1, seed)
    assert got.dtype == np.int64 and got.tolist() == want
    assert [index_shuffle(i, n - 1, seed) for i in range(n)] == want  # one index at a time
    if n > 1:  # grain's is a permutation at these sizes
        assert sorted(want) == list(range(n))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,bits", [(22872, 16), (65536, 16), (65537, 16), (65538, 18),
                                    (300001, 20)])
def test_sampled_indices_equal_grains(n, bits, seed):
    assert block_bits(n - 1) == bits
    sample = np.random.RandomState(n % 1000 + seed % 1000).choice(n, 2000, replace=False)
    assert index_shuffle(sample, n - 1, seed).tolist() == _grain(sample, n - 1, seed)


@pytest.mark.parametrize("rounds", [4, 6, 8])
def test_rounds_and_keys(rounds):
    # more rounds draw more seed_seq words (std::seed_seq's t changes at n >= 7)
    assert len(seed_seq_generate([5], rounds)) == rounds
    assert index_shuffle(np.arange(100), 99, 5, rounds).tolist() == _grain(range(100), 99, 5,
                                                                           rounds)
    with pytest.raises(ValueError):
        index_shuffle(0, 9, 5, rounds + 1)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("seed", [1234, 2**32 - 2])  # the second wraps at epoch 2
def test_record_stream_equals_grains_index_sampler(seed, shuffle):
    import grain.python as gp

    n, epochs = 12, 4
    sampler = gp.IndexSampler(num_records=n, shard_options=gp.NoSharding(), shuffle=shuffle,
                              num_epochs=None, seed=seed)
    want = [sampler[p].record_key for p in range(n * epochs)]
    assert list(itertools.islice(record_stream(n, shuffle, seed), n * epochs)) == want
    for e in range(epochs):
        assert epoch_order(n, e, shuffle, seed).tolist() == want[e * n:(e + 1) * n]


@pytest.mark.parametrize("seed", [-1, 2**32, 2**40])
def test_seeds_outside_32_bits_are_refused_as_grain_refuses_them(seed):
    import grain.python as gp

    with pytest.raises(ValueError):
        gp.IndexSampler(num_records=4, shard_options=gp.NoSharding(), shuffle=True,
                        num_epochs=None, seed=seed)
    with pytest.raises(ValueError):
        next(record_stream(4, True, seed))
    with pytest.raises(ValueError):
        index_shuffle(0, 3, seed)


def test_committed_grain_stream_is_the_ports():
    """The golden that the card's loader check reads (grain's DataLoader at
    worker_count 0 and 4, and unshuffled at 2; written by
    torch_jpeg_fixtures.py) is the port's batch order; at worker_count 0 it
    is also what grain gives here now."""
    import json

    import torch_jpeg_fixtures as fx
    from raft_optical_flow_tpu_torch.data.grain_pipeline import _BatchIndices

    with open(fx.GRAIN_STREAM_PATH) as f:
        golden = json.load(f)
    n, bs, seed = golden["num_records"], golden["batch_size"], golden["seed"]
    assert (n, bs, seed) == tuple(fx.GRAIN_STREAM[k] for k in ("num_records", "batch_size",
                                                               "seed"))
    for shuffle, key in ((True, "batches"), (False, "batches_no_shuffle")):
        for workers, want in golden[key].items():
            got = list(itertools.islice(iter(_BatchIndices(n, bs, shuffle, seed, int(workers))),
                                        len(want)))
            assert got == want
    assert fx.grain_batches(n, bs, seed, 0, len(golden["batches"]["0"])) == golden["batches"]["0"]
    assert golden["batches"]["0"] != golden["batches"]["4"]
