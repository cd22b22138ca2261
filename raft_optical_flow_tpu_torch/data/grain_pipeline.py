"""Process-worker input pipeline: the port's counterpart of
`raft_optical_flow_tpu/data/grain_pipeline.py` (`_FlowRecordSource`,
`GrainFlowLoader`), without grain, which the card's machine lacks.

    loader = GrainFlowLoader(dataset, batch_size=8, num_workers=4, seed=1234)
    for batch in loader:  # dict of numpy arrays, epochs chained, endless
        ...

Records. Record i is decoded and augmented with the generator
`np.random.default_rng((seed, i))`, the same in every epoch, as in the JAX
package, so `_FlowRecordSource(dataset, seed)[i]` equals the JAX one bit
for bit.

Order. The record stream is endless: epoch e visits every record once, in
the order of `np.random.default_rng((seed, e)).permutation(len(dataset))`
(0, 1, ... without shuffle), and batches are cut from the continuous stream
across epoch boundaries, as grain's `Batch` cuts them from an endless
`IndexSampler`; there is no partial batch to drop. grain's own order (its
`index_shuffle` permutation) cannot be reproduced without grain: the port's
order is its own, so an epoch holds the same records as the JAX loader's,
in another order.

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


def record_stream(num_records: int, shuffle: bool, seed: int) -> Iterator[int]:
    """The endless stream of record indices: one permutation per epoch."""
    epoch = 0
    while True:
        if shuffle:
            yield from np.random.default_rng((seed, epoch)).permutation(num_records).tolist()
        else:
            yield from range(num_records)
        epoch += 1


class _BatchIndices:
    """A DataLoader batch sampler: consecutive batch_size slices of the stream."""

    def __init__(self, num_records: int, batch_size: int, shuffle: bool, seed: int):
        self.args = (num_records, shuffle, seed)
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[List[int]]:
        stream = record_stream(*self.args)
        while True:
            yield [next(stream) for _ in range(self.batch_size)]


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
            batch_sampler=_BatchIndices(len(self._source), batch_size, shuffle, seed),
            num_workers=num_workers,
            collate_fn=_collate,
            multiprocessing_context="spawn" if num_workers > 0 else None,
        )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # the DataLoader iterator stops its workers when this generator is closed
        yield from self._loader
