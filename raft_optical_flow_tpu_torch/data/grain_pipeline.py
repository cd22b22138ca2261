"""Process-worker input pipeline: the port's counterpart of
`raft_optical_flow_tpu/data/grain_pipeline.py` (`_FlowRecordSource`,
`GrainFlowLoader`), without grain, which the card's machine lacks. It gives
the batches that the JAX loader gives through grain, record for record and
in order, at every `num_workers`.

    loader = GrainFlowLoader(dataset, batch_size=8, num_workers=4, seed=1234)
    for batch in loader:  # dict of numpy arrays, epochs chained, endless
        ...

Records. Record i is decoded and augmented with the generator
`np.random.default_rng((seed, i))`, the same in every epoch, as in the JAX
package, so `_FlowRecordSource(dataset, seed)[i]` equals the JAX one bit
for bit.

Order. The record stream is grain's `IndexSampler` with `num_epochs=None`:
position p of the endless stream lies in epoch e = p // n and visits record
`index_shuffle(p % n, n - 1, (seed + e) % 2**32, rounds=4)` (p % n without
shuffle), through the port's own copy of grain's C++ `index_shuffle`
(`data/index_shuffle.py`). A seed outside [0, 2**32) is refused, as grain
refuses it.

Batches. With num_workers = W = 0 the batches are consecutive batch_size
slices of the stream. With W > 0, grain gives worker w the stream positions
w, w + W, w + 2W, ...; each worker cuts its batches from its own positions
(its t-th batch holds positions w + W * (t * B + m), m < B), and the batches
come out round-robin: worker 0, 1, ..., W - 1, 0, 1, .... So the stream
depends on num_workers exactly as the JAX loader's does. Batch j is worker
j mod W's, and `torch.utils.data.DataLoader` hands batch j to its worker
j mod W and returns the batches in order.

Workers. With num_workers > 0 the records are loaded in worker processes
of `torch.utils.data.DataLoader`, started with the 'spawn' method: each is
a fresh interpreter, so none inherits the parent's CUDA context or its
threads (a forked child of a process that has initialised CUDA cannot use
CUDA, and forking a process that runs threads is unsafe), and the workers
never touch CUDA. The dataset is pickled to them, and each worker returns
a whole batch of numpy arrays, pickled back through a pipe (CPU tensors in
shared memory would save that copy, but a worker stopped while one is in
flight aborts). num_workers=0 loads in-process.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.utils.data

from raft_optical_flow_tpu_torch.data.index_shuffle import index_shuffle

KEYS = ("image1", "image2", "flow", "valid")


class _FlowRecordSource(torch.utils.data.Dataset):
    """The records of a FlowDataset, each drawn with default_rng((seed, i))."""

    def __init__(self, dataset, seed: int):
        self._dataset = dataset
        self._seed = seed

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self._seed, int(index)))
        img1, img2, flow, valid = self._dataset.__getitem__(int(index), rng=rng)
        return {"image1": img1, "image2": img2, "flow": flow, "valid": valid}


def _check_seed(seed: int) -> None:
    if not 0 <= seed < 2**32:  # grain's IndexSampler: "positive 32-bit integer"
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")


def epoch_order(num_records: int, epoch: int, shuffle: bool, seed: int) -> np.ndarray:
    """The record indices of one epoch, in grain's order."""
    positions = np.arange(num_records, dtype=np.int64)
    if not shuffle:
        return positions
    return index_shuffle(positions, num_records - 1, (seed + epoch) % 2**32, rounds=4)


def record_stream(num_records: int, shuffle: bool, seed: int) -> Iterator[int]:
    """The endless stream of record indices: grain's order, epoch after epoch."""
    _check_seed(seed)
    epoch = 0
    while True:
        yield from epoch_order(num_records, epoch, shuffle, seed).tolist()
        epoch += 1


def batch_positions(batch: int, batch_size: int, num_workers: int) -> List[int]:
    """The stream positions of output batch `batch`: consecutive without
    workers, else worker `batch % W`'s batch `batch // W` cut from its own
    positions w, w + W, ... (grain's split)."""
    if num_workers == 0:
        return list(range(batch * batch_size, (batch + 1) * batch_size))
    w, t = batch % num_workers, batch // num_workers
    return [w + num_workers * (t * batch_size + m) for m in range(batch_size)]


class _BatchIndices:
    """A DataLoader batch sampler: the record indices of each output batch."""

    def __init__(self, num_records: int, batch_size: int, shuffle: bool, seed: int,
                 num_workers: int):
        _check_seed(seed)
        self.n, self.shuffle, self.seed = num_records, shuffle, seed
        self.batch_size, self.num_workers = batch_size, num_workers

    def __iter__(self) -> Iterator[List[int]]:
        epochs = {}  # epoch -> its order, kept while batches still reach into it
        batch = 0
        while True:
            positions = batch_positions(batch, self.batch_size, self.num_workers)
            for e in {p // self.n for p in positions} - set(epochs):
                epochs[e] = epoch_order(self.n, e, self.shuffle, self.seed)
            yield [int(epochs[p // self.n][p % self.n]) for p in positions]
            batch += 1
            oldest = min(batch_positions(batch, self.batch_size, self.num_workers)) // self.n
            for e in [e for e in epochs if e < oldest]:
                del epochs[e]


def _collate(records) -> Dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in records]) for k in KEYS}


class GrainFlowLoader:
    """Endless batch iterator over a FlowDataset: dicts of numpy arrays
    {image1, image2 [N, H, W, 3] float32 0-255, flow [N, H, W, 2],
    valid [N, H, W]}, as `data/pipeline.py::FlowDataLoader` yields them.

    drop_last is accepted for the JAX signature; an endless stream has no
    last partial batch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 1234,
    ):
        if batch_size < 1 or num_workers < 0:
            raise ValueError(f"batch_size {batch_size}, num_workers {num_workers}")
        self._source = _FlowRecordSource(dataset, seed)
        self._loader = torch.utils.data.DataLoader(
            self._source,
            batch_sampler=_BatchIndices(len(self._source), batch_size, shuffle, seed,
                                        num_workers),
            num_workers=num_workers,
            collate_fn=_collate,
            multiprocessing_context="spawn" if num_workers > 0 else None,
        )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # the DataLoader iterator stops its workers when this generator is closed
        yield from self._loader
