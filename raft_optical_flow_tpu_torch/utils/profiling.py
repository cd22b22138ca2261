"""Profiling: call timing, parameter counts, memory, a model table, traces.

Counterpart of `raft_optical_flow_tpu/utils/profiling.py` (the reference's
`time_it` and `compare_models` roles):

  - `time_fn`: the median ms per call after a warm-up; on the card each call
    between two CUDA events, on the CPU the host clock (`time_calls` gives
    every reading);
  - `param_count`, `param_bytes` of a module or a state_dict;
  - `memory_analysis(fn, *args)`: measured bytes of one call on the card;
  - `compare_models`: parameters, latency and memory of RAFT-small,
    LiteFlowNet3-S, SimpleFlowNet and IFNet at batch 1;
  - `trace`: `torch.profiler` around a block, written as a Chrome trace;
  - `span(name)`: a host range of the port's own (`SPANS` lists every one)
    while a profiler records, one branch otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

# Every range the port opens: RAFT's layers (where each opens:
# models/raft.py), LiteFlowNet3's stages and mechanisms
# (models/liteflownet3.py), then the train step's phases (train/trainer.py).
SPANS = (
    "raft.forward",
    "raft.encode",
    "raft.volume",
    "raft.loop",
    "raft.lookup",
    "raft.update",
    "raft.upsample",
    "lfn3.forward",
    "lfn3.features",
    "lfn3.deform",
    "lfn3.modulate",
    "lfn3.match",
    "lfn3.subpixel",
    "lfn3.regularize",
    "lfn3.upsample",
    "lfn3.corr",
    "lfn3.warp",
    "lfn3.smooth",
    "train.data",
    "train.loss",
    "train.backward",
    "train.allreduce",
    "train.optimizer",
)

_NO_SPAN = contextlib.nullcontext()
# bound once: the attribute chain costs more than the call
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A `record_function` range named `name` on the launching thread while
    a profiler records (any `torch.profiler` or `torch.autograd.profiler`,
    `trace` among them), so the trace ties each kernel to the span it was
    launched in (by correlation id) on the device's clock; otherwise one
    shared null context, so an untraced span costs one branch."""
    return record_function(name) if _profiler_enabled() else _NO_SPAN


def _default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """`torch.profiler.profile` over the block (CPU and, with a card, CUDA
    activity); on exit the trace is written to `log_dir/trace.json`
    (Chrome's trace format, which Perfetto reads). Yields the profiler, whose
    `key_averages()` sums the kernels by name. The port's spans (`SPANS`)
    appear in every trace it writes, as `user_annotation` ranges."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_calls(fn: Callable, *args, num_reps: int = 10, warmup: int = 1,
               device=None) -> Tuple[List[float], object]:
    """fn(*args) `warmup` times, then `num_reps` timed calls: (ms of each,
    the first call's output). On the card each call is timed between two
    CUDA events after a synchronize (the card's span from the host's first
    launch to the last kernel's end); on the CPU by the host clock."""
    device = device or _default_device()
    out = None
    for i in range(warmup):
        r = fn(*args)
        out = r if i == 0 else out
    times = []
    for _ in range(num_reps):
        if device == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            r = fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        out = r if out is None else out
    return times, out


def time_fn(fn: Callable, *args, num_reps: int = 10, warmup: int = 1,
            device=None) -> Tuple[float, object]:
    """(median ms per call, the first call's output); see `time_calls`."""
    times, out = time_calls(fn, *args, num_reps=num_reps, warmup=warmup, device=device)
    return float(np.median(times)), out


def _tensors(params: Union[nn.Module, Mapping[str, torch.Tensor]]):
    return list(params.parameters()) if isinstance(params, nn.Module) else list(params.values())


def param_count(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters, or of a state_dict's tensors."""
    return sum(t.numel() for t in _tensors(params))


def param_bytes(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(params))


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Mapping):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def memory_analysis(fn: Callable, *args) -> Dict[str, float]:
    """Measured memory of one call fn(*args) on the card, in MiB:

      - `arg_mb`: the tensor arguments (the JAX package's meaning);
      - `output_mb`: the tensors returned (the same);
      - `peak_hbm_mb`: the most allocated during the call above what was
        allocated before it (`reset_peak_memory_stats`,
        `max_memory_allocated`); the JAX key is the compiler's whole-program
        peak, arguments included;
      - `temp_mb`: peak_hbm_mb less output_mb, the workspace the call held
        beyond its outputs (the JAX key is XLA's temp buffer size);
      - `total_buffers_mb`: the sum of arg, output and temp, as the JAX
        package sums them.

    Returns {} off the card, as the JAX package does where the backend
    does not expose it.
    """
    if not torch.cuda.is_available():
        return {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    mib = 2.0**20
    peak = (torch.cuda.max_memory_allocated() - base) / mib
    res = {"arg_mb": _nbytes(args) / mib, "output_mb": _nbytes(out) / mib, "peak_hbm_mb": peak}
    res["temp_mb"] = max(peak - res["output_mb"], 0.0)
    res["total_buffers_mb"] = res["arg_mb"] + res["output_mb"] + res["temp_mb"]
    return {k: round(v, 2) for k, v in res.items()}


def _gflops(fn: Callable, *args) -> float:
    """GFLOP of one call as `torch.utils.flop_counter` counts them: convs,
    transposed convs and matmuls only (no custom op, no elementwise work)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return counter.get_total_flops() / 1e9


def compare_models(height: int = 256, width: int = 448, num_reps: int = 5,
                   device="cuda") -> Dict[str, Dict]:
    """Parameters, size, latency (median ms of `num_reps` after a warm-up),
    GFLOP (convs and matmuls) and memory of the four families at batch 1,
    seeded weights, fp32 with TF32 off (the models' fp32 policy): RAFT-small
    (12 iterations, test mode), LiteFlowNet3-S, SimpleFlowNet, IFNet."""
    from raft_optical_flow_tpu_torch.models import (
        RAFT,
        IFNet,
        LFN3Config,
        LiteFlowNet3,
        RAFTConfig,
        SimpleFlowNet,
    )

    g = torch.Generator(device=device).manual_seed(0)
    a = torch.rand(1, height, width, 3, device=device, generator=g) * 255.0
    b = torch.rand(1, height, width, 3, device=device, generator=g) * 255.0
    pair = torch.stack([a, b], dim=1) / 255.0
    raft = RAFT(RAFTConfig(small=True), device=device)
    lfn3s = LiteFlowNet3(LFN3Config(use_s_version=True), device=device)
    sfn = SimpleFlowNet(device=device)
    ifn = IFNet(device=device)
    runs = (
        ("raft-small", raft, lambda: raft(a, b, iters=12, test_mode=True)[1]),
        ("liteflownet3s", lfn3s, lambda: lfn3s(pair)["flows"]),
        ("simple_flow", sfn, lambda: sfn(a / 255.0, b / 255.0)[-1]),
        ("ifnet", ifn, lambda: ifn(a / 255.0, b / 255.0)[0][-1]),
    )
    results = {}
    for name, model, fwd in runs:
        ms, _ = time_fn(fwd, num_reps=num_reps, device=device)
        entry = {"params": param_count(model), "model_mb": round(param_bytes(model) / 2**20, 2),
                 "latency_ms": round(ms, 3), "gflops": round(_gflops(fwd), 2)}
        entry.update(memory_analysis(fwd))
        results[name] = entry
    return results


if __name__ == "__main__":
    import json

    print(json.dumps(compare_models(), indent=2))
