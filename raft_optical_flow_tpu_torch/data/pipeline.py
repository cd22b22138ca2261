"""Host input pipeline: deterministic shuffled batches and the device feed.

Counterpart of `raft_optical_flow_tpu/data/pipeline.py` (`FlowDataLoader`,
`prefetch_to_device`): per-epoch shuffling and a per-sample RNG derived from
(seed, epoch, index), so batches do not depend on worker scheduling and a
resumed run skips to the exact samples it would have seen; a thread pool
loads samples. With `num_shards` > 1 (data parallelism, one process per
device) each process loads only its rows of every global batch. The device
feed copies each batch from pinned host memory without blocking.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def _collate(samples) -> Dict[str, np.ndarray]:
    img1, img2, flow, valid = zip(*samples)
    return {
        "image1": np.stack(img1),
        "image2": np.stack(img2),
        "flow": np.stack(flow),
        "valid": np.stack(valid),
    }


class FlowDataLoader:
    """Endless batches of a FlowDataset (epochs chained, each shuffled, its
    last partial batch dropped): {image1, image2 [N, H, W, 3] float32 0-255,
    flow [N, H, W, 2], valid [N, H, W]} numpy.

    batch_size is the GLOBAL batch size. With num_shards > 1 (data
    parallelism: num_shards processes on the mesh's 'data' axis, shard_id
    this process's coordinate) every process walks the same global index
    stream and loads only its contiguous batch_size / num_shards rows of
    each global batch, each sample with the RNG of (seed, epoch, index), so
    the shards put together are the one-process batch bit for bit.

    Its samples are loaded by a thread pool; `data/grain_pipeline.py::
    GrainFlowLoader` is the process-worker loader, with the JAX package's
    per-record draws.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 4,
        seed: int = 1234,
        prefetch_batches: int = 2,
        num_shards: int = 1,
        shard_id: int = 0,
    ):
        if num_shards > 1 and batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by num_shards {num_shards}")
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} out of range for {num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.local_batch_size = batch_size // num_shards

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx[: (len(idx) // self.batch_size) * self.batch_size]

    def _load_one(self, epoch: int, index: int):
        rng = np.random.default_rng((self.seed, epoch, int(index)))
        return self.dataset.__getitem__(int(index), rng=rng)

    def epochs(self, skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Endless iterator of this shard's batches; skip_batches
        fast-forwards the deterministic index stream by that many global
        batches without loading any data (resume)."""
        bs = self.local_batch_size
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            max_pending = self.prefetch_batches * bs

            def index_stream():
                # the global stream; this shard's rows of each global batch
                e = 0
                skip = skip_batches * self.batch_size
                lo = self.shard_id * bs
                while True:
                    idx = self._epoch_indices(e)
                    if skip >= len(idx):
                        skip -= len(idx)
                    else:
                        # skip is whole batches: epochs are batch-aligned
                        for b0 in range(skip, len(idx), self.batch_size):
                            for i in idx[b0 + lo:b0 + lo + bs]:
                                yield e, i
                        skip = 0
                    e += 1

            stream = index_stream()
            while True:
                while len(pending) < max_pending + bs:
                    e, i = next(stream)
                    pending.append(pool.submit(self._load_one, e, i))
                yield _collate([pending.popleft().result() for _ in range(bs)])

    def __iter__(self):
        return self.epochs()


def _to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def prefetch_to_device(iterator, size: int = 2, device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Wrap a host batch iterator with a `size`-deep queue of batches already on
    `device` (pinned host memory, non-blocking copies), filled by one thread.
    Closing the returned generator stops the thread and closes `iterator`."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        # errors reach the consumer instead of ending the stream quietly
        try:
            for batch in iterator:
                if not put(_to_device(batch, device)):
                    return
            put(done)
        except BaseException as exc:  # noqa: BLE001 - re-raised by the consumer
            put(exc)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
