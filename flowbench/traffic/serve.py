"""Serving traffic: a closed loop of one client calling RAFT in test mode.

Parameters (the mix's file): `batch` pairs of `height` x `width` frames a
call, padded to a multiple of 8 (`InputPadder`, `pad_mode`), `iters` GRU
iterations, a ring of `ring` distinct batches made at set-up and cycled
through, `compare_calls` calls of the window kept for the comparison
(drawn from the seed by reservoir sampling over every call), and
`profiled_calls` calls in the traced stretch.

A call is pad, forward, unpad, and the unpadded flow_up copied into the
client's pinned host buffer (reused by every call; a kept call's flow is
cloned out of it); its latency runs from the call to the flow on the host. Set-up makes the
weights and the ring on the device, builds the model and warms up with two
calls of the cell's one shape. The window runs calls until `seconds` have
passed (and at least `compare_calls` calls); the rate is every pair it
completed over its length, the tail every call's latency.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Tuple

import torch

from flowbench import bytes as fbytes
from flowbench import correct as fcorrect
from flowbench import flops as fflops
from flowbench.common import Marks, arch_of, sync, traced_stretch
from flowbench.harness import Context, Record, judge
from flowbench.inputs import make_batch
from flowbench.reference.raft import Arch, PlainRAFT
from flowbench.weights import make_weights

def program_system(ctx: Context, weights, arch: Arch):
    """The program under test: its RAFT with the benchmark's weights."""
    from raft_optical_flow_tpu_torch.models.raft import RAFT, RAFTConfig

    dtype = torch.bfloat16 if ctx.spec.config["policy"] == "bf16" else torch.float32
    model = RAFT(RAFTConfig(small=arch.small, corr_levels=arch.levels, compute_dtype=dtype),
                 device=ctx.device)
    model.load_state_dict(weights, strict=True)
    iters = int(ctx.spec.traffic["iters"])
    return model, lambda i1, i2: model(i1, i2, iters=iters, test_mode=True)


def control_system(ctx: Context, weights, arch: Arch):
    """The reference one precision step below the configuration's policy."""
    ref = PlainRAFT(arch, ctx.spec.config["control"])
    iters = int(ctx.spec.traffic["iters"])
    return None, lambda i1, i2: ref.forward(weights, i1, i2, iters, test_mode=True)


SYSTEMS = {"program": program_system, "control": control_system}


def run(ctx: Context) -> Record:
    from raft_optical_flow_tpu_torch.ops.padding import InputPadder

    t = ctx.spec.traffic
    arch = arch_of(ctx.spec.config)
    policy = ctx.spec.config["policy"]
    dev = ctx.device
    B, H, W, iters = int(t["batch"]), int(t["height"]), int(t["width"]), int(t["iters"])
    cuda = torch.device(dev).type == "cuda"
    marks = Marks(ctx.t0_wall)
    weights = make_weights(arch, ctx.seed, dev)
    ring = [make_batch(ctx.seed, i, B, H, W, dev) for i in range(int(t["ring"]))]
    for b in ring:
        del b["flow"], b["valid"]
    sync(dev)
    marks("weights and inputs")
    padder = InputPadder((B, H, W, 3), mode=t["pad_mode"])
    hw = (fflops.padded(H), fflops.padded(W))
    model, forward = SYSTEMS[ctx.system](ctx, weights, arch)
    marks("model")
    # the client's host buffer for the flow, pinned and reused by every call
    host = torch.empty(B, H, W, 2, pin_memory=cuda)

    def call(i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        b = ring[i % len(ring)]
        i1, i2 = padder.pad(b["image1"], b["image2"])
        flow_lo, flow_up = forward(i1, i2)
        host.copy_(padder.unpad(flow_up))
        return flow_lo, host

    for i in range(2):
        call(i)
        sync(dev)
        marks(f"warm-up call {i + 1}")
    marks.report()
    process_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - ctx.t0_wall

    # the window: a closed loop; reservoir sampling keeps compare_calls calls
    keep_n = int(t["compare_calls"])
    rng = random.Random(ctx.seed)
    kept: List[Tuple[int, torch.Tensor, torch.Tensor]] = []
    latencies: List[float] = []
    start = time.perf_counter()
    i = 0
    while True:
        c0 = time.perf_counter()
        flow_lo, flow_up = call(i)
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        if len(kept) < keep_n:
            kept.append((i, flow_lo, flow_up.clone()))
        else:
            j = rng.randrange(i + 1)
            if j < keep_n:
                kept[j] = (i, flow_lo, flow_up.clone())
        i += 1
        if c1 - start >= ctx.seconds and i >= keep_n:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    calls = len(latencies)

    rec = Record(kind="serve", policy=policy, setup_s=setup_s, window_s=window_s,
                 peak_mem_bytes=peak, process_peak_bytes=max(peak, process_peak),
                 attempted=calls, failed=0, pairs=calls * B, latencies_s=latencies,
                 work_flops=float(fflops.serve_flops(arch, B, *hw, iters)))
    if ctx.trace and model is not None:
        _traced(ctx, rec, model, call)
    del model, forward
    if cuda:
        torch.cuda.empty_cache()
    _compare(ctx, rec, weights, ring, padder, kept, arch)
    return rec


def _traced(ctx: Context, rec: Record, model, call: Callable) -> None:
    """`profiled_calls` calls under the profiler."""
    n = int(ctx.spec.traffic["profiled_calls"])

    def stretch():
        for i in range(n):
            call(i)
        sync(ctx.device)

    rec.trace, flows = traced_stretch(model.update_block, stretch)
    rec.profiled = n
    arch = arch_of(ctx.spec.config)
    rec.lookup_bound_s = fbytes.serve_bound_s(flows, arch.levels, arch.radius,
                                              2 if rec.policy == "bf16" else 4)


def _compare(ctx: Context, rec: Record, weights, ring, padder, kept, arch: Arch) -> None:
    """The kept calls against the reference on the same inputs and weights."""
    ref = PlainRAFT(arch, ctx.spec.config["policy"])
    iters = int(ctx.spec.traffic["iters"])
    pairs = []
    for i, flow_lo, flow_up in kept:
        b = ring[i % len(ring)]
        i1, i2 = padder.pad(b["image1"], b["image2"])
        r_lo, r_up = ref.forward(weights, i1, i2, iters, test_mode=True)
        pairs.append(((flow_lo, flow_up.to(r_up.device)), (r_lo, padder.unpad(r_up))))
        del r_lo, r_up
    rec.numbers = fcorrect.serve_numbers(pairs)
    rec.correct, rec.checks = judge(rec.numbers, ctx.spec.limits)
