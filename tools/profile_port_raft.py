#!/usr/bin/env python3
"""Profile one forward or training step of the PyTorch port on the GPU: RAFT-standard,
SimpleFlowNet, IFNet, or RAFT-small's UFlow training step.

    python3 tools/profile_port_raft.py [--batch 16] [--iters 32] [--dtype bf16]
    python3 tools/profile_port_raft.py --mode train [--batch 4] [--iters 12]
    python3 tools/profile_port_raft.py [--mode train] --alternate_corr [--remat]
    python3 tools/profile_port_raft.py --fused_gru [--alternate_corr]
    python3 tools/profile_port_raft.py --model simple_flow|ifnet [--mode train] [--dtype fp32]
    python3 tools/profile_port_raft.py --model uflow [--batch 4] [--iters 4]

`--mode serve` (default): the serving workload of `bench.py::main` (1024x436
frames padded to 1024x440, test mode). `--mode train`: one training step of
`tools/bench_train.py`'s `standard` config (368x496, frozen BatchNorm,
sequence loss, backward, clipped AdamW). `--alternate_corr` runs the
on-demand correlation (K4 forward, K5 and K6 backward) instead of the
materialized volume; `--remat` recomputes each GRU iteration in the
backward; `--fused_gru` runs the SepConvGRU through K7 (serving, or fp32
training). `--model simple_flow` or `ifnet`: serving at 432x1024
(`tools/bench_families.py`), batch 16 by default; training, the supervised
loss of the JAX trainers (`simple_flow_loss`; IFNet's flow[..., 2:4]) and
its backward at batch 8, 384x768 (`cli/train_flow.py`), no optimizer step.
`--model uflow`: one `FlowTrainer('raft_uflow_unsup')` step (fp32, batch 4,
256x384, 4 iterations, `checkpoints/raft_small.npz`, the occlusion masks on;
`tools/unsup_bootstrap_tpu.sh`'s round-5 crop), optimizer included.
Seeded random weights (but RAFT-small's) and data. The
call runs twice to warm up, then once under `torch.profiler`. Prints the
device time by kernel (the 20 largest, then each of the port's), the time
per group (the port's CUDA kernels, convolutions, matmuls, the rest), and
the device busy share:
summed kernel time over the host-clock wall time of the profiled call (the
profiler's own host overhead is inside that wall time, so the share is a
lower bound). `--trace PATH` also writes the Chrome trace. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (
    ("port kernels (lookup, GRU)", re.compile(r"lookup_level_kernel|coarse_fused_kernel|"
                                              r"wide_lookup_kernel|"
                                              r"lookup_level_bwd_kernel|ondemand_|"
                                              r"gru_pass_|gru_weight_image")),
    # cuDNN's FFT algorithms (fp32 without TF32 picks them for some shapes)
    # run as fft, region_transform and complex-product kernels
    ("convolution", re.compile(r"conv|fprop|implicit|dgrad|wgrad|cudnn|xmma|fft|"
                               r"region_transform|mult_and_sum_complex", re.I)),
    ("matmul", re.compile(r"gemm|cutlass|cublas", re.I)),
)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("raft", "simple_flow", "ifnet", "uflow"), default="raft")
    ap.add_argument("--mode", choices=("serve", "train"), default="serve")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 16 serving, 4 training (SimpleFlowNet and IFNet: 8)")
    ap.add_argument("--iters", type=int, default=None, help="default 32 serving, 12 training")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--alternate_corr", action="store_true", help="on-demand correlation")
    ap.add_argument("--remat", action="store_true", help="recompute each GRU iteration")
    ap.add_argument("--fused_gru", action="store_true", help="the SepConvGRU through K7")
    ap.add_argument("--trace", metavar="PATH", help="write the Chrome trace to PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_raft: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from raft_optical_flow_tpu_torch.models import RAFTConfig

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    train = args.mode == "train"
    if args.model == "uflow":
        train, dtype, args.mode, args.dtype = True, torch.float32, "train", "fp32"
    batch = args.batch or ((8 if args.model in ("simple_flow", "ifnet") else 4) if train else 16)
    iters = args.iters or ((4 if args.model == "uflow" else 12) if train else 32)
    if args.model == "uflow":
        run = _uflow_call(batch, iters)
    elif args.model == "raft":
        config = RAFTConfig(compute_dtype=dtype, alternate_corr=args.alternate_corr,
                            remat=args.remat, fused_gru=args.fused_gru)
        run = (_train_call if train else _serve_call)(config, batch, iters)
    else:
        run = _family_call(args.model, dtype, train, batch)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

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
          f"fused_gru={args.fused_gru}: wall {wall_ms:.3f} ms (profiled), "
          f"device {device_ms:.3f} ms, busy share {device_ms / wall_ms:.4f}, "
          f"{sum(k[1] for k in kernels)} kernel launches")
    totals = {name: 0.0 for name, _ in GROUPS}
    totals["other (elementwise, norms, copies)"] = 0.0
    for ms, _, key in kernels:
        group = next((name for name, pat in GROUPS if pat.search(key)), None)
        totals[group or "other (elementwise, norms, copies)"] += ms
    for name, ms in totals.items():
        print(f"  group {name}: {ms:.3f} ms ({ms / device_ms:.4f})")
    for ms, count, key in kernels[:20]:
        print(f"  {ms:9.3f} ms {count:6d}x  {key[:110]}")
    print("  the port's kernels:")
    for ms, count, key in kernels:
        if GROUPS[0][1].search(key):
            print(f"  {ms:9.3f} ms {count:6d}x  {key[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
