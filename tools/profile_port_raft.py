#!/usr/bin/env python3
"""Profile one forward or training step of the PyTorch port on the GPU: RAFT-standard,
SimpleFlowNet, IFNet, LiteFlowNet3, or RAFT-small's UFlow training step.

    python3 tools/profile_port_raft.py [--batch 16] [--iters 32] [--dtype bf16]
    python3 tools/profile_port_raft.py --mode train [--batch 4] [--iters 12]
    python3 tools/profile_port_raft.py [--mode train] --alternate_corr [--remat]
    python3 tools/profile_port_raft.py --fused_gru [--alternate_corr]
    python3 tools/profile_port_raft.py --small --dtype fp32 [--span raft.update]
    python3 tools/profile_port_raft.py --model simple_flow|ifnet [--mode train] [--dtype fp32]
    python3 tools/profile_port_raft.py --model uflow [--batch 4] [--iters 4]
    python3 tools/profile_port_raft.py --model lfn3 [--batch 16] [--dtype bf16]

`--mode serve` (default): the serving workload of `bench.py::main` (1024x436
frames padded to 1024x440, test mode). `--mode train`: one training step of
`tools/bench_train.py`'s `standard` config (368x496, frozen BatchNorm,
sequence loss, backward, clipped AdamW). `--alternate_corr` runs the
on-demand correlation (K4 forward, K5 and K6 backward) instead of the
materialized volume; `--remat` recomputes each GRU iteration in the
backward; `--fused_gru` runs the SepConvGRU through K7 (serving, or fp32
training); `--small` runs RAFT-small. `--model simple_flow` or `ifnet`: serving at 432x1024
(`tools/bench_families.py`), batch 16 by default; training, the supervised
loss of the JAX trainers (`simple_flow_loss`; IFNet's flow[..., 2:4]) and
its backward at batch 8, 384x768 (`cli/train_flow.py`), no optimizer step.
`--model uflow`: one `FlowTrainer('raft_uflow_unsup')` step (fp32, batch 4,
256x384, 4 iterations, `checkpoints/raft_small.npz`, the occlusion masks on;
`tools/unsup_bootstrap_tpu.sh`'s round-5 crop), optimizer included.
`--model lfn3`: LiteFlowNet3 (standard) serving full-HD pairs (1920x1080,
rescaled inside to 1920x1088), the benchmark's seeded weights and frames
(`flowbench/weights_lfn3.py`, `flowbench/inputs.py`); serving only.
Seeded random weights (but RAFT-small's) and data. The
call runs twice to warm up, then once under `torch.profiler`. Prints, for
each of the port's spans the call opened (`utils/profiling.py::SPANS`:
RAFT's layers, LiteFlowNet3's stages and mechanisms, and the train step's
phases), how often it opened, its host
ms and the device ms of the kernels launched inside it (by launch time, on
any thread, so the backward's kernels that autograd's device thread
launches count in `train.backward`; spans nest, so each row holds its
children), the device ms of kernels launched outside every span, and the
device time of the 20 largest kernels by name; `--span NAME` also prints
the kernels launched inside that span, by name. `--trace PATH` also writes
the Chrome trace. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the spans that no other span holds
OUTERMOST = ("raft.forward", "lfn3.forward", "train.data", "train.loss", "train.backward",
             "train.allreduce", "train.optimizer")


def _serve_call(config, batch, iters):
    from raft_optical_flow_tpu_torch.models import RAFT
    from raft_optical_flow_tpu_torch.ops.padding import InputPadder

    model = RAFT(config, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(batch)
    frames = [torch.from_numpy(rng.uniform(0, 255, (batch, 436, 1024, 3))
                               .astype(np.float32)).cuda() for _ in range(2)]
    img1, img2 = InputPadder(frames[0].shape, mode="sintel").pad(*frames)
    return lambda: model(img1, img2, iters=iters)


def _train_call(config, batch, iters):
    from raft_optical_flow_tpu_torch.train.configs import StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state, raft_train_step

    stage = StageConfig(name="profile", stage="things", num_steps=100, batch_size=batch,
                        lr=1.25e-4, image_size=(368, 496))
    state = create_train_state(config, stage, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {
        "image1": torch.rand(batch, 368, 496, 3, device="cuda", generator=g) * 255.0,
        "image2": torch.rand(batch, 368, 496, 3, device="cuda", generator=g) * 255.0,
        "flow": torch.rand(batch, 368, 496, 2, device="cuda", generator=g) * 10.0 - 5.0,
        "valid": torch.ones(batch, 368, 496, device="cuda"),
    }
    return lambda: raft_train_step(state, data, iters=iters, freeze_bn=True)


def _family_call(name, dtype, train, batch):
    from raft_optical_flow_tpu_torch.losses import simple_flow_loss
    from raft_optical_flow_tpu_torch.models import IFNet, SimpleFlowConfig, SimpleFlowNet

    gen = torch.Generator().manual_seed(0)
    if name == "simple_flow":
        model = SimpleFlowNet(SimpleFlowConfig(compute_dtype=dtype), device="cuda", generator=gen)
    else:
        model = IFNet(compute_dtype=dtype, device="cuda", generator=gen)
    H, W = (384, 768) if train else (432, 1024)
    g = torch.Generator(device="cuda").manual_seed(0)
    img1, img2 = (torch.rand(batch, H, W, 3, device="cuda", generator=g) for _ in range(2))
    if not train:
        return lambda: model(img1, img2)
    gt = torch.rand(batch, H, W, 2, device="cuda", generator=g) * 10.0 - 5.0
    valid = torch.ones(batch, H, W, device="cuda")

    def step():
        model.zero_grad(set_to_none=True)
        if name == "simple_flow":
            preds = model(img1, img2, train=True)
        else:
            preds = [f[..., 2:4] for f in model(img1, img2, train=True)[0]]
        simple_flow_loss(preds, gt, valid, img1)[0].backward()

    return step


def _uflow_call(batch, iters):
    from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    restore = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    trainer = FlowTrainer("raft_uflow_unsup", (256, 384), restore_variables=restore,
                          step_kwargs=dict(iters=iters, occlusion_warmup_steps=0))
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = {k: torch.rand(batch, 256, 384, 3, device="cuda", generator=g) * 255.0
              for k in ("image1", "image2")}
    return lambda: trainer.train_step(frames)


def _lfn3_call(dtype, batch):
    from flowbench.inputs import make_batch
    from flowbench.weights_lfn3 import make_weights
    from raft_optical_flow_tpu_torch.models.liteflownet3 import liteflownet3

    model = liteflownet3(device="cuda", compute_dtype=dtype)
    model.load_state_dict(make_weights(0, "cuda"))
    b = make_batch(0, 0, batch, 1080, 1920, "cuda")
    images = torch.stack([b["image1"], b["image2"]], dim=1) / 255.0
    return lambda: model(images)


def kernels_in_span(events, name):
    """{kernel name: [device ms, launches]} of the kernels whose launch (the
    runtime call of the same correlation id) started inside a host range
    `name`."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") == name)
    starts = [r[0] for r in ranges]
    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")}
    by = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        t = launched.get((e.get("args") or {}).get("correlation"))
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ranges[i][1]:
            by[e["name"]][0] += float(e["dur"]) / 1e3
            by[e["name"]][1] += 1
    return by


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("raft", "simple_flow", "ifnet", "uflow", "lfn3"),
                    default="raft")
    ap.add_argument("--mode", choices=("serve", "train"), default="serve")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 16 serving, 4 training (SimpleFlowNet and IFNet: 8)")
    ap.add_argument("--iters", type=int, default=None, help="default 32 serving, 12 training")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--alternate_corr", action="store_true", help="on-demand correlation")
    ap.add_argument("--remat", action="store_true", help="recompute each GRU iteration")
    ap.add_argument("--fused_gru", action="store_true", help="the SepConvGRU through K7")
    ap.add_argument("--small", action="store_true", help="RAFT-small (model raft)")
    ap.add_argument("--span", metavar="NAME", help="list the kernels launched inside this span")
    ap.add_argument("--trace", metavar="PATH", help="write the Chrome trace to PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_raft: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from flowbench.trace import STRETCH, Trace
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.utils.profiling import SPANS

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    train = args.mode == "train"
    if args.model == "uflow":
        train, dtype, args.mode, args.dtype = True, torch.float32, "train", "fp32"
    batch = args.batch or ((8 if args.model in ("simple_flow", "ifnet") else 4) if train else 16)
    iters = args.iters or ((4 if args.model == "uflow" else 12) if train else 32)
    if args.model == "uflow":
        run = _uflow_call(batch, iters)
    elif args.model == "lfn3":
        if train:
            raise SystemExit("profile_port_raft: --model lfn3 profiles serving only")
        run = _lfn3_call(dtype, batch)
    elif args.model == "raft":
        config = RAFTConfig(small=args.small, compute_dtype=dtype,
                            alternate_corr=args.alternate_corr, remat=args.remat,
                            fused_gru=args.fused_gru)
        run = (_train_call if train else _serve_call)(config, batch, iters)
    else:
        run = _family_call(args.model, dtype, train, batch)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            run()
            torch.cuda.synchronize()
    path = args.trace
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    else:
        fd, path = tempfile.mkstemp(prefix="profile_port_raft_", suffix=".json")
        os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if not args.trace:
            os.unlink(path)
    trace = Trace(events)

    kernels = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type) or getattr(e, "is_user_annotation", False):
            continue  # annotated ranges (Optimizer.step) would count their kernels twice
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    if device_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"{torch.cuda.get_device_name(0)} model={args.model} mode={args.mode} batch={batch} "
          f"iters={iters} "
          f"dtype={args.dtype} alternate_corr={args.alternate_corr} remat={args.remat} "
          f"fused_gru={args.fused_gru} small={args.small}: device {device_ms:.3f} ms, "
          f"{sum(k[1] for k in kernels)} kernel launches")
    opened = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    inside = 0.0
    for name in SPANS:
        ranges = [e for e in opened if e["name"] == name]
        if not ranges:
            continue
        device_s = trace.kernel_s_in_range(name) or 0.0
        inside += device_s if name in OUTERMOST else 0.0
        host_ms = sum(float(e["dur"]) for e in ranges) / 1e3
        print(f"  span {name:16s} {len(ranges):4d}x  host {host_ms:9.3f} ms  "
              f"device {device_s * 1e3:9.3f} ms")
    if inside:
        print(f"  outside every span: device {(trace.kernel_s() - inside) * 1e3:.3f} ms")
    for ms, count, key in kernels[:20]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:110]}")
    if args.span:
        inside_span = sorted(kernels_in_span(events, args.span).items(), key=lambda kv: -kv[1][0])
        print(f"kernels launched inside {args.span}: {len(inside_span)} names")
        for key, (ms, count) in inside_span:
            print(f"  {ms:9.3f} ms {count:6d}x  {key[:110]}")
    if args.trace:
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
