"""Multi-process data parallelism on `torch.distributed`: one process per device.

Counterpart of `raft_optical_flow_tpu/parallel/distributed.py`. JAX runs one
program over every device of a process and lets XLA reduce over the global
arrays; torch's idiom is one process per device, so what XLA did implicitly
is explicit here:

  - `initialize(...)` connects the process to its peers
    (`torch.distributed.init_process_group` over `tcp://host:port`); a no-op
    when no multi-process run is asked for, so every entry point calls it.
  - `FlowDataLoader(num_shards, shard_id)` (data/pipeline.py) loads this
    process's rows of every global batch.
  - Inside `data_parallel(group)` the training code reduces over the
    processes of `group`, so that N processes with a global batch B take the
    step that one process takes with batch B:
      * BatchNorm normalizes with the statistics of the global batch
        (`models/layers.py::batch_norm_train`);
      * a loss or metric that divides a sum over the batch by a count over
        the batch takes the global count (`batch_ratio`);
      * random draws over the batch axis are drawn at the global batch size
        from a generator in the same state on every process, and each keeps
        its own rows (`local_rows`), so the generators stay in lockstep;
      * gradients are averaged before the optimizer clips them
        (`average_gradients`), and the step's metrics are averaged
        (`mean_over_ranks`).
    Every loss term and metric a step computes inside is this process's
    share: its mean over the processes is the global value.

Outside `data_parallel` (or with a group of None) every helper is the
identity and no collective runs.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from raft_optical_flow_tpu_torch.utils.profiling import span

# The group the batch is split over, inside `data_parallel`. A context
# variable rather than an argument: BatchNorm, the losses and the random
# draws that read it lie several calls under the step, in code that runs
# unchanged on one process.
_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


def local_device(device="cuda") -> torch.device:
    """This process's device: `device` as given when it names an index or is
    not CUDA; else the CUDA device of index LOCAL_RANK (when set), or of the
    process's rank modulo the device count (several processes may share one
    card)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", _cuda_index(process_info()[0]))


def _cuda_index(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> bool:
    """Connect this process to the others of the run; True if it did.

    coordinator_address is "host:port" of the rendezvous (process 0 listens
    there); num_processes and process_id are the world size and this
    process's rank. Missing ones come from the environment torchrun sets
    (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK). With no argument and no
    multi-process environment (WORLD_SIZE unset or 1) this is a no-op and
    returns False, as the JAX function does on a single process. A request
    that names more than one process but cannot be met raises: it never
    runs alone instead.

    backend None takes NCCL when `device` is CUDA and gloo otherwise. For a
    CUDA device the process's card (`local_device`) becomes the current
    one before the group starts.
    """
    env_world = os.environ.get("WORLD_SIZE")
    if coordinator_address is None and num_processes is None and process_id is None:
        if env_world is None or int(env_world) <= 1:
            return False
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and env_world is not None:
        num_processes = int(env_world)
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    missing = [name for name, v in (("coordinator_address", coordinator_address),
                                    ("num_processes", num_processes),
                                    ("process_id", process_id)) if v is None]
    if missing:
        raise ValueError(f"a multi-process run needs {', '.join(missing)} (arguments, or "
                         "MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK in the environment)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for {num_processes} processes")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else _cuda_index(process_id))
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id,
    )
    return True


def shutdown() -> None:
    """Leave the process group (after `initialize`); a no-op without one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(rank, world size): the loader's shard_id and num_shards; (0, 1)
    without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_lead_host() -> bool:
    """True on the process that logs and writes checkpoints (rank 0)."""
    return process_info()[0] == 0


def fetch_replicated(tree):
    """A host numpy copy of a tree (dict, list, tuple) of tensors that every
    process holds whole (metrics, parameters after a step). No collective
    runs, so any subset of the processes may call it."""
    if isinstance(tree, dict):
        return {k: fetch_replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_replicated(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def assert_batch_divisible(global_batch_size: int, n: Optional[int] = None) -> int:
    """The per-process batch size; raises if the global batch does not
    split evenly over the processes (the run's, or n of them)."""
    if n is None:
        n = process_info()[1]
    if global_batch_size % n:
        raise ValueError(f"global batch size {global_batch_size} not divisible by "
                         f"process count {n}")
    return global_batch_size // n


# ------------------------------------------------------------------ collectives


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of t over the processes of `group` as a new tensor, with no
    gradient; t itself without a group."""
    if group is None:
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's processes; the backward sums the cotangents the
    same way, so each process's input gets the gradient of the sum of every
    process's objective."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    """`all_reduce_sum` for a value that carries a gradient (autograd sees
    it); t itself without a group."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite each tensor with process src's, in place; a no-op without a
    group. Under NCCL a CPU tensor travels through the current CUDA device
    (NCCL carries CUDA tensors only)."""
    if group is None:
        return
    nccl = dist.get_backend(group) == "nccl"
    with torch.no_grad():
        for t in tensors:
            if nccl and t.device.type != "cuda":
                buf = t.to(torch.device("cuda", torch.cuda.current_device()))
                dist.broadcast(buf, src=src, group=group)
                t.copy_(buf)
            else:
                dist.broadcast(t.data, src=src, group=group)


def broadcast_float(value: Optional[float], device, src: int = 0, group=None) -> Optional[float]:
    """Process src's value (a float or None) on every process; value itself
    without a group."""
    if group is None:
        return value
    t = torch.tensor([np.nan if value is None else float(value)], dtype=torch.float64,
                     device=device)
    dist.broadcast(t, src=src, group=group)
    v = float(t.item())
    return None if np.isnan(v) else v


def barrier(group=None) -> None:
    """Wait for every process of the group; a no-op without one."""
    if group is not None:
        dist.barrier(group=group)


# ------------------------------------------------------------- data parallelism


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, training code reduces over the processes of `group`
    (None: a single process, nothing reduces). The batch each process
    holds is its rows of the global batch, in rank order."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def data_group():
    """The group of the enclosing `data_parallel`, or None."""
    return _DATA_GROUP.get()


def data_world() -> int:
    """The number of processes the batch is split over (1 outside
    `data_parallel`)."""
    group = _DATA_GROUP.get()
    return 1 if group is None else dist.get_world_size(group)


def local_rows(draw: Callable[[int], torch.Tensor], n_local: int, blocks: int = 1) -> torch.Tensor:
    """This process's rows of a random draw over the batch axis.

    draw(n) returns n rows drawn from a generator that is in the same state
    on every process. Inside `data_parallel` the draw is made at the global
    size and each process keeps its rows, so the result is the one process's
    draw sliced, and every generator moves by the same amount. blocks > 1:
    the rows are that many stacked copies of the local batch (e.g. RAFT's
    encoder on [image1; image2]), each taking its rows of its own block.
    Outside, draw(n_local)."""
    group = _DATA_GROUP.get()
    if group is None:
        return draw(n_local)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    b = n_local // blocks
    full = draw(n_local * world)
    B = b * world
    return torch.cat([full[j * B + rank * b:j * B + (rank + 1) * b] for j in range(blocks)])


def batch_ratio(num: torch.Tensor, den: torch.Tensor, eps: float = 0.0,
                floor: Optional[float] = None) -> torch.Tensor:
    """num / (den + eps), or num / max(den, floor), where num and den are
    sums over the batch: this process's share of the global ratio.

    Inside `data_parallel` den is summed over the processes (with its
    gradient) and num is scaled by their number, so that the mean of the
    shares over the processes is the global ratio and their averaged
    gradient its gradient. Outside, the plain ratio."""
    group = _DATA_GROUP.get()
    if group is not None:
        den = all_reduce_sum_grad(den, group)
        num = num * dist.get_world_size(group)
    if floor is not None:
        return num / torch.clamp(den, min=floor)
    return num / (den + eps)


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Inside `data_parallel`: replace each parameter's gradient (a missing
    one counts as zeros) by its mean over the processes, through one
    all-reduce of a flat buffer (the span `train.allreduce`). Outside, a
    no-op."""
    group = _DATA_GROUP.get()
    if group is None:
        return
    with span("train.allreduce"):
        params = list(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
        flat /= dist.get_world_size(group)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n


def mean_over_ranks(metrics: Dict[str, object], keep: Tuple[str, ...] = ()) -> Dict[str, object]:
    """Inside `data_parallel`: each 0-d tensor of metrics (except the keys in
    keep, which are global already) averaged over the processes, through one
    all-reduce; other values as they are. Outside, metrics itself."""
    group = _DATA_GROUP.get()
    if group is None:
        return metrics
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0 and k not in keep]
    if not keys:
        return metrics
    stacked = all_reduce_sum(torch.stack([metrics[k].detach().float() for k in keys]), group)
    stacked /= dist.get_world_size(group)
    out = dict(metrics)
    for k, v in zip(keys, stacked):
        out[k] = v.to(metrics[k].dtype)
    return out
