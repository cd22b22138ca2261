"""Serving traffic for LiteFlowNet3: a closed loop of one client calling
`LiteFlowNet3.forward(images, training=False)`.

Parameters (the mix's file): `batch` pairs of `height` x `width` frames a
call (the model rescales them inside to multiples of 32 and its flow back),
a ring of `ring` distinct batches made at set-up and cycled through,
`compare_calls` calls of the window kept for the comparison (drawn from the
seed by reservoir sampling over every call), and `profiled_calls` calls in
the traced stretch.

A call is the batch's frames scaled to [0, 1] and stacked ([B, 2, H, W,
3]), the forward, and `flows` copied into the client's pinned host buffer
(reused by every call); its latency runs from the call to the flow on the
host. A kept call keeps its own output tensors on the device, so keeping
one copies nothing inside the window. Set-up makes the weights
(`flowbench/weights_lfn3.py`) and the ring on the device, builds the model
and warms up with two calls of the cell's one shape. The window runs calls
until `seconds` have passed (and at least `compare_calls` calls); the rate
is every pair it completed over its length.

The numbers that decide `correct`, the kept calls against the reference
(`reference/liteflownet3.py`) on the same frames and weights, after the
window, once the program is freed:
  - `flow_epe_mean`: the mean end-point error of the full-size flow (px),
    averaged over the calls;
  - `flow_epe_max`: its largest end-point error;
  - `conf_abs_max`: the largest gap of the full-size confidence.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from flowbench import lfn3_counts
from flowbench import trace as ftrace
from flowbench.common import Marks, sync
from flowbench.flops import padded
from flowbench.harness import Context, Record, judge
from flowbench.inputs import make_batch
from flowbench.reference.liteflownet3 import OUTPUT_STRIDE, PlainLFN3
from flowbench.weights_lfn3 import make_weights

Output = Tuple[torch.Tensor, torch.Tensor]  # flows [B, 1, H, W, 2], confs [B, 1, H, W, 1]


def program_system(ctx: Context, weights):
    """The program under test: its LiteFlowNet3 with the benchmark's weights."""
    from raft_optical_flow_tpu_torch.models.liteflownet3 import liteflownet3

    dtype = torch.bfloat16 if ctx.spec.config["policy"] == "bf16" else torch.float32
    model = liteflownet3(device=ctx.device, compute_dtype=dtype)
    model.load_state_dict(weights, strict=True)
    return model, lambda images: model(images, training=False)


def control_system(ctx: Context, weights):
    """The reference one precision step below the configuration's policy."""
    ref = PlainLFN3(ctx.spec.config["control"])
    return None, lambda images: ref.forward(weights, images)


SYSTEMS = {"program": program_system, "control": control_system}


def stacked(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The pair's frames in [0, 1], [B, 2, H, W, 3]."""
    return torch.stack([batch["image1"], batch["image2"]], dim=1) * (1.0 / 255.0)


def numbers(pairs: Sequence[Tuple[Output, Output]]) -> Dict[str, float]:
    """pairs: (program (flows, confs), reference (flows, confs)) per compared
    call, on one device."""
    means, maxes, conf = [], [], []
    for (p_flow, p_conf), (r_flow, r_conf) in pairs:
        e = torch.linalg.vector_norm(p_flow.float() - r_flow.float(), dim=-1)
        means.append(float(e.mean()))
        maxes.append(float(e.max()))
        conf.append(float((p_conf.float() - r_conf.float()).abs().max()))
    return {"flow_epe_mean": sum(means) / len(means), "flow_epe_max": max(maxes),
            "conf_abs_max": max(conf)}


def run(ctx: Context) -> Record:
    t = ctx.spec.traffic
    policy = ctx.spec.config["policy"]
    dev = ctx.device
    B, H, W = int(t["batch"]), int(t["height"]), int(t["width"])
    cuda = torch.device(dev).type == "cuda"
    marks = Marks(ctx.t0_wall)
    weights = make_weights(ctx.seed, dev)
    ring = [make_batch(ctx.seed, i, B, H, W, dev) for i in range(int(t["ring"]))]
    for b in ring:
        del b["flow"], b["valid"]
    sync(dev)
    marks("weights and inputs")
    model, forward = SYSTEMS[ctx.system](ctx, weights)
    marks("model")
    # the client's host buffer for the flow, pinned and reused by every call
    host = torch.empty(B, H, W, 2, pin_memory=cuda)

    def call(i: int) -> Output:
        out = forward(stacked(ring[i % len(ring)]))
        host.copy_(out["flows"][:, 0])
        return out["flows"], out["confs"]

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
    kept: List[Tuple[int, Output]] = []
    latencies: List[float] = []
    start = time.perf_counter()
    i = 0
    while True:
        c0 = time.perf_counter()
        out = call(i)
        c1 = time.perf_counter()
        latencies.append(c1 - c0)
        if len(kept) < keep_n:
            kept.append((i, out))
        else:
            j = rng.randrange(i + 1)
            if j < keep_n:
                kept[j] = (i, out)
        del out
        i += 1
        if c1 - start >= ctx.seconds and i >= keep_n:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    calls = len(latencies)
    Hp, Wp = padded(H, OUTPUT_STRIDE), padded(W, OUTPUT_STRIDE)

    rec = Record(kind="serve", policy=policy, setup_s=setup_s, window_s=window_s,
                 peak_mem_bytes=peak, process_peak_bytes=max(peak, process_peak),
                 attempted=calls, failed=0, pairs=calls * B, latencies_s=latencies,
                 work_flops=float(lfn3_counts.forward_flops(B, Hp, Wp)))
    if ctx.trace and model is not None:
        _traced(ctx, rec, call, lfn3_counts.corr_bound_s(B, Hp, Wp, policy))
    del model, forward
    if cuda:
        torch.cuda.empty_cache()
    _compare(ctx, rec, weights, ring, kept)
    return rec


def _traced(ctx: Context, rec: Record, call: Callable, corr_bound_s: float) -> None:
    """`profiled_calls` calls under the profiler; the correlations' least
    time over them (read by `lfn3_corr_roofline.serve`)."""
    n = int(ctx.spec.traffic["profiled_calls"])

    def stretch():
        for i in range(n):
            call(i)
        sync(ctx.device)

    rec.trace = ftrace.Trace(ftrace.profile(stretch))
    rec.profiled = n
    rec.corr_bound_s = n * corr_bound_s


def _compare(ctx: Context, rec: Record, weights, ring, kept) -> None:
    """The kept calls against the reference on the same frames and weights."""
    ref = PlainLFN3(ctx.spec.config["policy"])
    pairs = []
    for i, (flows, confs) in kept:
        r = ref.forward(weights, stacked(ring[i % len(ring)]))
        pairs.append(((flows, confs), (r["flows"], r["confs"])))
        del r
    rec.numbers = numbers(pairs)
    rec.correct, rec.checks = judge(rec.numbers, ctx.spec.limits)
