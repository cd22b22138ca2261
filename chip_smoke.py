#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`raft_optical_flow_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--phases device,kernels,small,standard,train,ondemand,fused_gru,lfn3,
                                    simple_flow,ifnet,flow_train,data_eval,frames,utils,parallel,
                                    multicard,timing,small_update]

Phases (each prints one line when it ends; any failure raises and the exit
code is not 0):

  device    the card's name and power limit (nvidia-smi), then the nvcc build
            of the port's CUDA kernels and its seconds;
  kernels   K1 (corr_lookup_level), K2 (corr_lookup_coarse_fused) and K3
            (corr_lookup_level_bwd, K1's volume gradient) against their plain
            PyTorch versions on the card, at the serving shapes (1024x440
            input: Q = 55*128, levels 55x128 .. 6x16), radius 3 and 4, fp32
            and bf16 volumes, outputs and cotangents, far out-of-bounds coords
            and a crop whose deepest level is empty; and at the training
            shapes (368x496: levels 46x62 .. 5x7, radius 4), batch 4 bf16
            and batch 10 fp32, and the UFlow step's (RAFT-small, batch 4,
            256x384 and its 240x368 student crop: levels 32x48 .. 4x6 and
            30x46 .. 3x5, radius 3, fp32 volume); K1, K2 and K8
            (corr_lookup_all_levels, every level in one launch) bit for bit with their plain versions, also
            on centres just below integers; then K8's public entry driven
            once (no model path launches it);
  small     RAFT-small, fp32 with TF32 off, checkpoint weights, against the
            reference golden (tests/goldens/raft_small.npz); the kernels'
            launch counts must rise by `iters` each;
  standard  RAFT-standard under the bf16 policy at full width (seeded weights,
            1024x436 padded to 1024x440, 32 iterations), batch 1 and 16: the
            kernel path against the plain-lookup path, and pairs/s;
  train     the training path, three parts: RAFT-small fp32 train-mode
            forward against the golden `train_pred_last`, then one train step
            through the kernels against one through the plain lookup, each
            layer's gradient on its own scale;
            RAFT-standard under the bf16 policy at batch 4, 368x496, 12
            iterations (tools/bench_train.py's `standard`): ms/step, pairs/s,
            peak memory, launches per step; RAFT-standard fp32 at the chairs
            stage (batch 10, BatchNorm training): two steps, BN statistics
            moved, ms/step, peak memory; and the RAFT-small kernel step run
            twice with cudnn.deterministic only (no PyTorch deterministic
            algorithms): every layer's gradient must agree bit for bit;
  ondemand  the on-demand correlation (`alternate_corr`): K4
            (corr_ondemand_fwd), K5 (corr_ondemand_bwd_df1) and K6
            (corr_ondemand_bwd_df2, with its prepass corr_ondemand_df2_plan)
            against their plain versions at the batch-16 serving shapes, the
            batch-4 bf16 and batch-10 fp32 training shapes, radius 3 and 4,
            far out-of-bounds coords and an empty deepest level, K6 twice bit
            for bit, the prepass equal to its plain version, and the routes
            K4's tiles took (either dtype); RAFT-standard bf16 at
            1024x440, 32 iterations: batch 16 against the materialized kernel
            path (pairs/s, peak memory of both), batch 1 against the plain
            on-demand path; RAFT-standard fp32 at batch 1 (one Sintel pair of
            `evaluate --alternate_corr`, K4's fp32 route) against the
            materialized fp32 path; RAFT-small fp32 against the golden; one
            RAFT-small train step through K4-K6 against one through the plain
            versions, and the kernel step run twice; the bf16 batch-4 368x496
            training step, remat off and on, and the fp32 chairs step (batch
            10, BatchNorm training: K4's and K5's fp32 routes) (ms/step, peak
            memory, launches per step);
  fused_gru the fused SepConvGRU (`fused_gru`): K7 (sepconv_gru_pass) against
            its plain version pass by pass at the batch-16 bf16 serving shape,
            the batch-4 fp32 training shape, W = 37, the 1-high and 1-wide
            levels and 300-long rows (bf16: segments with a halo); RAFT-standard bf16 serving (1024x440, 32
            iterations) at batch 16 and 1 and fp32 at batch 1 against the
            unfused path with the same weights (64 K7 launches per forward;
            ms, pairs/s, peak memory of both); one fp32 training step (batch
            2, 368x496, 12 iterations) against the unfused one, against the
            unfused one pinned to K7's GRU values, and against itself; the
            bf16 fused training step must raise; alternate_corr with
            fused_gru;
  lfn3      LiteFlowNet3, plain PyTorch (no port kernel on its path; none may
            launch), fp32 with TF32 off unless bf16 is named: standard and
            S+PseudoReg at the goldens' params against the reference goldens
            (tests/test_lfn3_parity.py's tolerances) and standard under bf16
            against the fp32 golden; all four variants on the card against
            the port on the CPU (64x96, batch 2, flows max|d| <= 1e-4);
            serving at 436x1024 (scaled to 448x1024 inside): standard and S
            in fp32 and bf16 at batch 16 and 1, the PseudoReg variants in
            bf16 at batch 1, the median ms/call of 5 after a warm-up,
            pairs/s, peak memory and bf16-vs-fp32 EPE; training, standard and
            S+PseudoReg fp32: ms per forward+backward and peak memory at
            batch 8, 384x768 (cli/train_flow.py), and at batch 2, 64x96, on
            two draws of the inputs, the card's loss (rel 1e-5) and each
            layer's gradient against the CPU and against the CPU in float64,
            within max(2e-5, 2x the spread of the card's step run twice, 2x
            the CPU fp32 error against float64), with the card's error
            under cudnn.deterministic and the cuDNN conv kernels reported;
  simple_flow  SimpleFlowNet, plain PyTorch (no port kernel on its path; none
            may launch), fp32 with TF32 off unless bf16 is named: at the
            golden's params against the reference golden (atol 1e-3 per
            scale) and under bf16 against the same golden (per scale mean
            |d| < 4e-2, max < 2e-1); the card against the port on the CPU
            (64x96, batch 2, flows max|d| <= 1e-4); serving at 432x1024
            (tools/bench_families.py) in fp32 and bf16 at batch 16 and 1,
            and at 256x256 batch 1 (the reference's shape): the median
            ms/call of 5 after a warm-up, pairs/s, peak memory; the
            supervised gradient step, BatchNorms in training mode: ms per
            forward+backward and peak memory at batch 8, 384x768, and at
            batch 2, 64x96 the card against the CPU as in phase lfn3;
  ifnet     IFNet, the same way: fp32 against the golden (flows atol 2e-3,
            masks and warped images 1e-3), bf16 (flow_2 mean |d| < 5e-3,
            max < 5e-2), feature_res_warp against the reference order
            (flow_0 equal, later flows mean < 0.06, max < 0.5); card vs CPU
            with and without feature_res_warp; serving at 432x1024 in fp32,
            bf16 and bf16 with feature_res_warp at batch 16 and 1; gradient
            steps supervised (flow[..., 2:4] through simple_flow_loss) and
            unsupervised (laploss);
  flow_train  the family trainers and RAFT-small's UFlow step
            (`train/trainers.py::FlowTrainer.train_step`, fp32): each of the
            seven kinds (lfn3, lfn3_unsup, simple_flow, simple_flow_unsup,
            ifnet, ifnet_unsup at batch 8, 384x768; raft_uflow_unsup at batch
            4, 256x384, 4 iterations, checkpoints/raft_small.npz) for a
            warm-up and 3 timed steps, at the goldens' params: the median
            ms/step, peak memory, finite metrics, grad_norm > 0, and per step
            64 launches each of K1 and K3 for UFlow, none for the families;
            the full-width UFlow step through K1 and K3 against the same
            step through the plain lookup, same weights, real frames,
            deterministic algorithms on (loss bit for bit, each layer
            within max(2e-5, 2x the kernel step's spread, 2x the plain
            step's backward rounding floor)); each kind at batch 2 on the
            card against the port on the CPU (loss rel 1e-5, each layer
            within max(2e-5, 2x the card's spread); UFlow at 48x64, 24
            launches each, its gate also 2x the CPU step's floor under a
            one-ulp change of the weights, the card's error against the
            port in float64 on the CPU within it, and that error, the
            CPU's and the card's under cudnn.deterministic reported);
            UFlow's range map
            and UnFlow's splat twice bit for bit and within 1e-5 of the CPU;
            `cli/train_flow.py` for two synthetic steps, its weights file
            reloaded;
  data_eval the data layer and the inference drivers, from files on disk: the
            native data library built (g++); FlyingChairs (12 pairs at
            384x512, .ppm + .flo, chairs_split.txt 10/2), Sintel (ambush_2
            and market_2, 3 frames, clean and final, 436x1024) and KITTI
            (three real frame sizes, 16-bit flow PNGs, about half the pixels
            valid) written by the port's writers from the golden pair (each
            frame the next one warped by a smooth seeded flow, so the flow
            is known) and read back bit for bit; `cli/train_raft.py --stage
            chairs --data_root` (RAFT-standard fp32, BN training, seeded
            weights, batch 10, 368x496) for 3 steps with `--validation
            chairs` firing once: finite losses, K1 and K3 48 launches a step,
            the validation's K1 and K2, ms/step, peak memory, and
            FlowDataLoader's pairs/s (batch 10, 4 workers) beside the
            step's; RAFT-small fp32 (checkpoint) through `cli/evaluate.py`
            on Sintel (32 iterations), KITTI (24; one 384x1280 bucket) and
            Chairs (24), each run again through the plain lookup under
            cudnn.deterministic: every pair's flows bit for bit, metrics
            equal, K1 and K2 `iters` launches a pair, EPE and ms/pair
            reported; the Sintel submission with warm start and the KITTI
            submission read back; `cli/demo.py` (RAFT-small, LiteFlowNet3 at
            the goldens' params) on the Sintel scene, PNGs read back;
  frames    the frame decoders and the process-worker loader: every committed
            fixture (tests/goldens/jpeg/: JPEGs written by Pillow and cv2,
            and by jpeg_writer.c in the codings those do not write:
            arithmetic SOF9/SOF10, lossless SOF3, YCCK, progressive files
            libjpeg smooths; Adam7 PNGs of every colour type and depth)
            read by `read_gen` and held equal to PIL's array
            (np.array_equal), the 436x1024 JPEG pairs (Huffman 4:2:0 q95,
            and arithmetic progressive SOF10 4:2:0 q90) to the sha256 of
            PIL's arrays; each pair frame's decode time on the host (median
            of 20 reads, one thread); `cli/demo.py` (RAFT-small, checkpoint,
            20 iterations) on a folder of both pairs (five pairs, the SOF10
            pair among them, the Huffman pair twice): K1 and K2 20 launches
            each per pair, each flow equal (torch.equal) to the same frames
            through the plain lookup, PNGs read back, ms per pair;
            `GrainFlowLoader` over a chairs tree (batch 10, 368x496 crops)
            in-process and with 4 worker processes, every record of every
            batch the (seed, i) draw of the index that grain's DataLoader
            gives there at worker_count 0 and 4 (committed:
            tests/goldens/grain_stream.json), pairs/s of both beside
            FlowDataLoader with 4 threads;
  utils     the utils (`utils/`): RAFT-small (checkpoint) exported through
            `torch.export` at the JAX defaults (1x440x1024, 20 iterations,
            fp32), saved, loaded and run: flow equal to eager (torch.equal),
            K1 and K2 20 launches each per exported call, ms/call of both;
            LiteFlowNet3 (the goldens' params) exported at 1x384x1024 and
            held equal to eager; reference-named .pth files (RAFT-small with
            `module.` prefixes, LiteFlowNet3 in a Lightning wrapper) written
            from the .npz files, converted, loaded strict=True, forwards bit
            for bit; `grad_parity.run_all()` (K3 fp32 and bf16, K5/K6 fp32
            and on bf16 fmaps), every entry within its bar; the host cost
            of a K1 or K2 call through its custom op against the direct
            wrapper; compare_models() (four families, 1x256x448) and
            memory_analysis of RAFT-standard bf16 at batch 16, 1024x440;
            InputPadder's pad holding nothing beyond its output, and
            RAFT-standard bf16 batch 16 on its NHWC output against an NCHW-
            backed view (in turns); TensorBoardWriter's scalars and flow
            image read back with every CRC checked. Under 150 s;
  parallel  data parallelism (`parallel/`), each check in fresh processes of
            this script (`--parallel-worker`), started after phase device
            has built the kernels, so this process holds no process group:
            (a) the RAFT-standard chairs step (fp32, BatchNorm training,
            batch 2, 368x496, 12 iterations, K1 and K3, cudnn.deterministic)
            through `RAFTTrainer`'s mesh path on an NCCL group of one
            process against the same step without a group: loss, metrics,
            every gradient, parameter and buffer equal (torch.equal), 48
            launches each of K1 and K3, and 5 more steps of each, in
            turns, for their ms; (b) the same step at global batch 4 on two gloo processes
            sharing the one card (CUDA tensors; NCCL refuses two ranks on
            one device), 2 rows each, against one process at batch 4: the
            ranks' parameters, buffers, metrics and generators equal,
            metrics within rel 1e-5 + abs 1e-6, parameters within the JAX
            package's CLI bound (max |d| < 1e-3, under 1% of the elements
            off by more than 1e-6), BatchNorm running statistics within
            1e-5; 5 more steps each for their ms (the ranks share the
            card); (c) `spatial_sharded_ondemand_corr` on two gloo ranks: K4
            on each rank's 28-row slab of a 56x128 fmap (C = 256, 4 levels,
            radius 4; the serving fmap's 55 rows do not split in two and
            must be refused), fp32 and bf16, on the frame's query grid, the
            slabs gathered, equal (torch.equal) to one K4 call on the whole
            frame, with K4's bf16 routes of both launches;
  multicard every visible card when there are two or more (on one card it
            logs "multicard: 1 card visible, not run" and adds nothing to
            the result; asked for by --phases with fewer than two cards it
            fails; it never falls back to gloo), one NCCL process per card
            (`--parallel-worker multicard`, LOCAL_RANK=i), the numbers for
            four: (a) the chairs step (RAFT-standard fp32, BatchNorm
            training, 368x496, 12 iterations, cudnn.deterministic) at
            global batch 8, 2 rows a card, against one process at 8 on
            cuda:0 (run by process 0 after the cards' part): phase parallel
            (b)'s gates (ranks bit for bit equal, generators equal, metrics
            within rel 1e-5 + abs 1e-6, parameters max |d| < 1e-3 with
            under 1% over 1e-6, BatchNorm running statistics within 1e-5,
            48 K1 and 48 K3 launches a step on every rank), ms/step on the
            cards and on one card (5 steps each after the compared one), the
            scaling (4-card pairs/s over 1-card pairs/s), and the NCCL
            kernels' device ms in one step under torch.profiler on rank 0;
            (b) the same step at global batch 4 on the ('data', 'space')
            mesh (2, 2) against one process at 4, the same gates ('space'
            peers bit for bit equal); (c) `spatial_sharded_ondemand_corr`
            on 4 'space' ranks, a 64x128 fmap (C = 256, 4 levels, radius
            4), fp32 and bf16, 16-row slabs, a seeded cotangent of the
            gathered whole taken back, against one K4, K5 and K6 call on
            the frame on cuda:0: the gathered forward and the fmap1 gradient
            equal (torch.equal), each level's gradient within max_rel 2e-5
            (fp32; bf16 levels: one bf16 step of the fp32 sums + 2e-5 *
            max|ref|), every rank's gradients equal, one launch each of K4,
            K5, K6 and its prepass per rank; (d) `python -m
            raft_optical_flow_tpu_torch.cli.train_raft --stage chairs
            --batch_size 8 --num_steps 3` on phase data_eval's chairs tree
            with no --dist_* flag (4 processes, each logging its cuda:i),
            with explicit --dist_* flags over 4 processes, and under
            CUDA_VISIBLE_DEVICES=0, at once, cudnn.deterministic in every
            process (a sitecustomize on PYTHONPATH): the first two's
            weights files equal bit for bit, the third within (a)'s
            parameter gate. Under 300 s;
  timing    K1, K2, K4, K7 and K8 at the batch-16 serving shapes, K3, K5 and K6 at
            the batch-4 training shapes, each first held against its plain
            version on the inputs it is timed on: kernel, plain version, a
            PyTorch library yardstick (F.grid_sample, its backward, and for
            K4-K6 the dot with fmap1; timed only, never used by the port),
            and the bound: bytes at 3.35 TB/s or operations at the peak rate
            of the operands' type, whichever is larger (K1, K2 and K8 also
            log their bytes counted in 32-byte sectors and in 64-byte units,
            with the rate of the latter at the kernel's time, and K1 and K2
            their time on a smooth field, ms_smooth). Every kernel is
            timed in an eager loop; K3, about as short as its wrapper's host
            time, is also timed as CUDA-graph replays (with its yardsticks
            and its four levels of one iteration: the graph_* keys). K4, K5
            and K6 are also timed on a smooth field (grid + a bilinear 4x8
            field of +-8 px: the ms_smooth key), with the routes K4's tiles
            took on both inputs; K6's time is its wrapper's whole call, prepass
            included, and the prepass has a row of its own (both also as
            CUDA-graph replays: graph_ms). K4's and K5's fp32 routes have
            keys of their own in the same rows (fp32_*: K4 at the
            batch-16 and, fp32_b1_*, batch-1 serving shapes, K5 at the fp32
            chairs shape, batch 10; each on a smooth field too), beside
            `_ondemand_library` in fp32 with TF32 off and a bound whose
            operations run at the fastest fp32-accurate rate (67 TFLOP/s on
            the CUDA cores or a third of the 495 TFLOP/s TF32 rate). K7's
            yardstick is the unfused SepConvGRU pass (three cuDNN convs and
            their elementwise work); its row also gives the fp32 route's
            time per launch at the batch-2 training shape (fp32_ms) and the
            batch-1 serving shape (fp32_serve_ms), each beside the unfused
            fp32 pass with TF32 off (fp32_library_ms, fp32_serve_library_ms)
            and its bound at the fp32 CUDA-core rate, and its log line the
            bf16 weight bytes per launch worked out from the launch plan. K8's yardstick is
            the four F.grid_sample calls.

  small_update  K9 (kernels/small_update.py), RAFT-small's update-block
            convolutions, at the serving shape (batch 16, 55x128): each of its
            eight convolutions against its plain version (max_rel 2e-5), then
            timed: the kernel's device time as CUDA-graph replays (so the
            host's launch time is not in it) and in an eager loop, the plain
            version, the library (cuDNN's fp32 convolution over the
            concatenated input, TF32 off, the algorithm it chooses today) and
            the bound, the operations at the fp32-accurate rate (495 / 3
            TFLOP/s) and at the fp32 CUDA-core rate (67); the whole step
            against the block's module path; K9's launches in a RAFT-small
            serving forward of 32 iterations.

With every phase run (the default) the last two lines are a JSON object of
per-kernel numbers and `{"ok": true, "device": {...}}`. Runs on CUDA only: it
exits non-zero without a card, and imports only torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from raft_optical_flow_tpu_torch.utils.grad_parity import VJP_TOL  # the VJP gates, one place

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "kernels", "small", "standard", "train", "ondemand", "fused_gru", "lfn3",
          "simple_flow", "ifnet", "flow_train", "data_eval", "frames", "utils", "parallel",
          "multicard", "timing", "small_update")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16, dense tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32, dense tensor cores
# the fastest fp32-accurate rate: the CUDA cores, or three split TF32 passes
FP32_ACCURATE_FLOPS_PER_S = max(FP32_FLOPS_PER_S, TF32_FLOPS_PER_S / 3)
FLOPS_PER_S = {torch.float32: FP32_FLOPS_PER_S, torch.bfloat16: BF16_FLOPS_PER_S}
SERVE_HW = (436, 1024)  # bench.py::main: Sintel frames, padded to 440x1024
ITERS = 32
TRAIN_HW = (368, 496)  # tools/bench_train.py `standard` and the chairs crop
TRAIN_ITERS = 12
GATE_ITERS = 1  # depth of the fused-vs-unfused gradient gate (_fused_train)
K1_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/corr_lookup.cu"
K1_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:72"  # _lookup_level_kernel
K2_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:337"  # _coarse_fused_kernel
K3_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:162"  # _lookup_level_bwd_kernel
K4_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/corr_ondemand.cu"
K4_TPU = "raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:129"  # _fwd_level_kernel
K5_TPU = "raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:251"  # _bwd_df1_kernel
K6_TPU = "raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:266"  # _bwd_df2_kernel
K7_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/gru_fused.cu"
K7_TPU = "raft_optical_flow_tpu/kernels/gru_fused.py:80"  # _gru_pass_kernel
K8_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:431"  # _fused_lookup_kernel
K9_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/small_update.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device time of fn() over n calls, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int, reps: int = 20) -> float:
    """Mean device time of fn() when its launches run back to back: reps calls
    captured in one CUDA graph, replayed n times, by CUDA events. For kernels
    shorter than their wrapper's host time, where an eager loop measures the
    host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up on the capture stream (cuBLAS workspaces)
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def serving_pyramid(B, h, w, dtype, seed, C=256, levels=4):
    """Correlation pyramid from seeded random fmaps, as the model builds it."""
    from raft_optical_flow_tpu_torch.ops.corr import build_corr_pyramid_from_fmaps

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(B, h, w, C, device="cuda", generator=g)
    f2 = torch.randn(B, h, w, C, device="cuda", generator=g)
    return build_corr_pyramid_from_fmaps(f1, f2, levels, dtype)


def serving_coords(B, h, w, seed, max_disp=8.0):
    from raft_optical_flow_tpu_torch.ops.grid import coords_grid

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = (torch.rand(B, h, w, 2, device="cuda", generator=g) * 2 - 1) * max_disp
    return (coords_grid(B, h, w, device="cuda") + d).contiguous()


def smooth_coords(B, h, w, seed, max_disp=8.0):
    """The grid plus a smooth field, as RAFT's flow is: a 4x8 grid of
    displacements uniform in +-max_disp, resized bilinearly to h x w."""
    from raft_optical_flow_tpu_torch.ops.grid import coords_grid

    g = torch.Generator(device="cuda").manual_seed(seed)
    d = (torch.rand(B, 2, 4, 8, device="cuda", generator=g) * 2 - 1) * max_disp
    d = F.interpolate(d, size=(h, w), mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
    return (coords_grid(B, h, w, device="cuda") + d).contiguous()


# ---------------------------------------------------------------------------
# phases


def phase_device(state):
    from raft_optical_flow_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(state["smi"])
    log(f"device: torch.cuda.get_device_name={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} cuda={torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    entry = ""
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:  # the kernel the next lines are about
            entry = line.split("'")[1] if "'" in line else ""
        if any(k in line for k in ("registers", "spill", "wgmma", "arning")):
            log(f"  ptxas: {line.strip()}  [{entry[:96]}]")
    built = "built" if _build.build_seconds is not None else "reused"
    log(f"phase device: ok, kernels {built} in {secs:.2f} s ({lib.name})")


def _check_equal(name, out, ref):
    """K1, K2 and K8 repeat their plain version's fp32 operations in its order:
    the same bits, or the kernel is wrong."""
    if out.dtype != ref.dtype or not torch.equal(out, ref):
        d = float((out.float() - ref.float()).abs().max()) if out.shape == ref.shape else None
        raise AssertionError(f"{name}: differs from its plain version (max|d| {d!r})")


def phase_kernels(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup

    err = {"corr_lookup_level": 0.0, "corr_lookup_coarse_fused": 0.0, "corr_lookup_level_bwd": 0.0,
           "corr_lookup_all_levels": 0.0}
    k3_rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0

    def check_k8(pyramid, coords, radius, tag):
        """K8 (every level, fp32 out) bit for bit with its plain version."""
        nonlocal n_checks
        out = ck.corr_pyramid_lookup_cuda_fused(pyramid, coords, radius)
        ref = ck.corr_pyramid_lookup_fused_plain(pyramid, coords, radius)
        if out.dtype != torch.float32:
            raise AssertionError(f"K8 {tag} r{radius}: {out.dtype} out")
        _check_equal(f"K8 {tag} r{radius}", out, ref)
        err["corr_lookup_all_levels"] = max(err["corr_lookup_all_levels"],
                                            float((out - ref).abs().max()))
        n_checks += 1
        return out

    def compare(pyramid, coords, radius, tag, far_rows=0):
        nonlocal n_checks
        B, h, w, _ = coords.shape
        flat = coords.reshape(B, h * w, 2).contiguous()
        for out_dtype in (torch.float32, torch.bfloat16):
            for lvl, c in enumerate(pyramid):
                if c.shape[2] == 0 or c.shape[3] == 0:
                    continue
                cl = (flat * (1.0 / 2**lvl)).contiguous()
                out = ck.corr_lookup_level(c, cl, radius, out_dtype)
                ref = ck.corr_lookup_level_plain(c, cl, radius, out_dtype)
                _check_equal(f"K1 {tag} l{lvl} {out_dtype}", out, ref)
                err["corr_lookup_level"] = max(err["corr_lookup_level"],
                                               float((out.float() - ref.float()).abs().max()))
                n_checks += 1
            out = ck.corr_lookup_coarse_fused(pyramid[1:], flat, radius, out_dtype)
            ref = ck.corr_lookup_coarse_fused_plain(pyramid[1:], flat, radius, out_dtype)
            _check_equal(f"K2 {tag} {out_dtype}", out, ref)
            err["corr_lookup_coarse_fused"] = max(err["corr_lookup_coarse_fused"],
                                                  float((out.float() - ref.float()).abs().max()))
            n_checks += 1
        check_k8(pyramid, coords, radius, tag)
        # K3 at every level, cotangents in both dtypes, dcorr in the volume's
        vol_dtype = pyramid[0].dtype
        gen = torch.Generator(device="cuda").manual_seed(31 + radius)
        K2 = (2 * radius + 1) ** 2
        for g_dtype in (torch.float32, torch.bfloat16):
            g = torch.randn(B, h * w, K2, device="cuda", generator=gen).to(g_dtype)
            for lvl, c in enumerate(pyramid):
                Hl, Wl = c.shape[2:]
                cl = (flat * (1.0 / 2**lvl)).contiguous()
                before = ck.LAUNCHES["corr_lookup_level_bwd"]
                out = ck.corr_lookup_level_bwd(cl, g, Hl, Wl, radius, vol_dtype)
                if tuple(out.shape) != (B, h * w, Hl, Wl) or out.dtype != vol_dtype:
                    raise AssertionError(f"K3 {tag} l{lvl}: shape {tuple(out.shape)} {out.dtype}")
                if Hl == 0 or Wl == 0:
                    if ck.LAUNCHES["corr_lookup_level_bwd"] != before:
                        raise AssertionError("K3 launched on an empty level")
                    continue
                ref32 = ck.corr_lookup_level_bwd_plain(cl, g, Hl, Wl, radius, torch.float32)
                rel = float((out.float() - ref32).abs().max() / ref32.abs().max())
                k3_rel[vol_dtype] = max(k3_rel[vol_dtype], rel)
                err["corr_lookup_level_bwd"] = max(
                    err["corr_lookup_level_bwd"],
                    float((out.float() - ref32.to(vol_dtype).float()).abs().max()))
                if not rel <= VJP_TOL[vol_dtype] or not torch.isfinite(out.float()).all():
                    raise AssertionError(f"K3 {tag} l{lvl} g {g_dtype}: max_rel {rel:.3e}")
                if far_rows and bool(out[:, : far_rows * w].ne(0).any()):
                    raise AssertionError("K3: far out-of-bounds queries got a gradient")
                n_checks += 1

    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8  # 55 x 128
    for vol_dtype in (torch.float32, torch.bfloat16):
        pyr = serving_pyramid(1, h, w, vol_dtype, seed=1)
        assert [tuple(c.shape[2:]) for c in pyr] == [(55, 128), (27, 64), (13, 32), (6, 16)]
        for radius in (3, 4):
            coords = serving_coords(1, h, w, seed=2 + radius)
            # a band of queries far outside every level (both signs), and some
            # straddling the border
            coords[:, :2] += 1.0e6
            coords[:, 2:4] -= 1.0e6
            coords[:, 4:6, :, 0] = w + radius - 0.5
            # and centres just below integers, where fl(c + (a - r)) rounds up
            # across an integer (the taps of an axis span K+2 pixels)
            coords[:, 6:8] = torch.nextafter(coords[:, 6:8].round(),
                                             torch.full_like(coords[:, 6:8], -math.inf))
            compare(pyr, coords, radius, f"serve {vol_dtype} r{radius}", far_rows=4)
            flat = coords.reshape(1, h * w, 2).contiguous()
            far = ck.corr_lookup_level(pyr[0], flat, radius)[:, : 4 * w]
            if bool(far.ne(0).any()):
                raise AssertionError("far out-of-bounds windows are not zero")
        del pyr
    # the shapes of phase train (368x496: levels 46x62 .. 5x7, radius 4):
    # batch 4 with a bf16 volume (the bf16 policy: bf16 windows and
    # cotangents) and batch 10 with an fp32 volume (the chairs stage)
    th, tw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    for B, vol_dtype in ((4, torch.bfloat16), (10, torch.float32)):
        pyr = serving_pyramid(B, th, tw, vol_dtype, seed=50 + B)
        assert [tuple(c.shape[2:]) for c in pyr] == [(46, 62), (23, 31), (11, 15), (5, 7)]
        compare(pyr, serving_coords(B, th, tw, seed=60 + B), 4, f"train B={B} {vol_dtype}")
        del pyr
        torch.cuda.empty_cache()
    # the shapes of phase flow_train's UFlow step (RAFT-small, batch 4,
    # 256x384 and its 240x368 student crop: levels 32x48 .. 4x6 and 30x46 ..
    # 3x5, 128-channel fmaps, fp32 volume, radius 3)
    for crop in (0, UFLOW_KW["selfsup_crop"]):
        uh, uw = (UFLOW_HW[0] - 2 * crop) // 8, (UFLOW_HW[1] - 2 * crop) // 8
        pyr = serving_pyramid(UFLOW_B, uh, uw, torch.float32, seed=70 + crop, C=128)
        compare(pyr, serving_coords(UFLOW_B, uh, uw, seed=80 + crop), 3,
                f"uflow B={UFLOW_B} {uh}x{uw}")
        del pyr
    # a 56x128 crop: levels 7x16, 3x8, 1x4, 0x2 (the deepest is empty)
    for vol_dtype in (torch.float32, torch.bfloat16):
        pyr = serving_pyramid(2, 7, 16, vol_dtype, seed=9)
        assert pyr[-1].shape[2] == 0
        coords = serving_coords(2, 7, 16, seed=10)
        compare(pyr, coords, 3, f"empty-level {vol_dtype}")
        if bool(check_k8(pyr, coords, 4, f"empty-level {vol_dtype}")[..., 3 * 81:].ne(0).any()):
            raise AssertionError("K8: empty level not zero")
        out = ck.corr_lookup_coarse_fused(pyr[1:], coords.reshape(2, 112, 2).contiguous(), 3)
        if bool(out[..., 2 * 49:].ne(0).any()):
            raise AssertionError("K2: empty level not zero")
        for fuse in (False, True):
            got = ck.corr_pyramid_lookup_cuda(pyr, coords, 3, torch.float32, fuse)
            ref = corr_pyramid_lookup(pyr, coords, 3)
            if not torch.equal(got, ref):
                raise AssertionError(f"pyramid lookup fuse={fuse} differs from the plain version")
    torch.cuda.synchronize()
    state["max_abs_err"] = err
    log(f"kernels: corr_lookup_level max_abs_err={err['corr_lookup_level']!r} "
        f"corr_lookup_coarse_fused max_abs_err={err['corr_lookup_coarse_fused']!r} "
        f"corr_lookup_level_bwd max_abs_err={err['corr_lookup_level_bwd']!r} "
        f"max_rel fp32={k3_rel[torch.float32]!r} bf16={k3_rel[torch.bfloat16]!r} "
        f"corr_lookup_all_levels max_abs_err={err['corr_lookup_all_levels']!r} "
        f"checks={n_checks} (tolerance: K1, K2 and K8 bit for bit; K3 max_rel <= 2e-5 "
        f"fp32 volume, 3e-2 bf16) "
        f"launches={dict(ck.LAUNCHES)}")
    # K8's path is its public entry (no model path launches it, in the JAX
    # package as here): one call at the batch-16 bf16 serving shape, counted
    # from 0
    pyr = serving_pyramid(16, h, w, torch.bfloat16, seed=11)
    coords = serving_coords(16, h, w, seed=12)
    reset_all()
    out = ck.corr_pyramid_lookup_cuda_fused(pyr, coords, 4)
    torch.cuda.synchronize()
    state["k8_launches"] = launch_counts()
    expect_launches(state["k8_launches"], {"corr_lookup_all_levels": 1}, "K8's public entry")
    if tuple(out.shape) != (16, h, w, 4 * 81) or not torch.isfinite(out).all():
        raise AssertionError("K8 output has the wrong shape or is not finite")
    log(f"K8 path: corr_pyramid_lookup_cuda_fused batch 16 {h}x{w} bf16 volume r=4 -> "
        f"{tuple(out.shape)} {out.dtype}, launches {state['k8_launches']}")
    del pyr, out
    torch.cuda.empty_cache()
    log("phase kernels: ok")


def phase_small(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    model = RAFT(RAFTConfig(small=True), device="cuda")
    model.load_state_dict(load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz")))
    img1 = torch.from_numpy(g["image1"]).float()[None].cuda()
    img2 = torch.from_numpy(g["image2"]).float()[None].cuda()
    iters = int(g["iters"])
    ck.reset_launches()
    flow_low, flow_up = model(img1, img2, iters=iters)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    if launches != {"corr_lookup_level": iters, "corr_lookup_coarse_fused": iters,
                    "corr_lookup_level_bwd": 0, "corr_lookup_all_levels": 0}:
        raise AssertionError(f"RAFT-small launches {launches}, expected {iters} of K1 and K2")
    low_err = np.abs(flow_low.cpu().numpy() - g["flow_low"]).max()
    epe = np.linalg.norm(flow_up.cpu().numpy() - g["flow_up"], axis=-1)
    log(f"small: iters={iters} flow_low max|d|={low_err!r} flow_up EPE mean={epe.mean()!r} "
        f"max={epe.max()!r} launches={launches}")
    if not (low_err <= 2e-3 and epe.mean() < 1e-3 and epe.max() < 5e-3):
        raise AssertionError("RAFT-small does not match the golden")
    log("phase small: ok")


def _serving_inputs(B, seed):
    from raft_optical_flow_tpu_torch.ops.padding import InputPadder

    rng = np.random.RandomState(seed)
    H, W = SERVE_HW
    a = torch.from_numpy(rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)).cuda()
    padder = InputPadder(a.shape, mode="sintel")
    return padder, *padder.pad(a, b)


def phase_standard(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig

    cfg = RAFTConfig(small=False, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    model = RAFT(cfg, device="cuda", generator=gen)
    plain = RAFT(RAFTConfig(small=False, compute_dtype=torch.bfloat16, corr_impl="plain"),
                 device="cuda")
    plain.load_state_dict(model.state_dict())
    results = {}
    for B, n_timed in ((1, 4), (16, 2)):
        padder, img1, img2 = _serving_inputs(B, seed=B)
        assert tuple(img1.shape) == (B, 440, 1024, 3)
        ck.reset_launches()
        _, flow_up = model(img1, img2, iters=ITERS)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)  # the main path's run
        if launches != {"corr_lookup_level": ITERS, "corr_lookup_coarse_fused": ITERS,
                        "corr_lookup_level_bwd": 0, "corr_lookup_all_levels": 0}:
            raise AssertionError(f"RAFT-standard launches {launches}, expected {ITERS} of K1, K2")
        flow = padder.unpad(flow_up)
        if tuple(flow.shape) != (B, *SERVE_HW, 2) or not torch.isfinite(flow).all():
            raise AssertionError("RAFT-standard output has the wrong shape or is not finite")
        _, flow_plain = plain(img1, img2, iters=ITERS)
        epe = torch.linalg.norm(flow_up - flow_plain, dim=-1)
        t0 = time.perf_counter()
        for _ in range(n_timed):
            model(img1, img2, iters=ITERS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_timed
        results[B] = {"ms": ms, "pairs_per_s": B * 1e3 / ms, "launches": launches,
                      "epe_mean": float(epe.mean()), "epe_max": float(epe.max()),
                      "mean_abs_flow": float(flow_up.abs().mean())}
        log(f"standard bf16 batch={B}: {ms:.3f} ms/call {B * 1e3 / ms:.3f} pairs/s "
            f"kernel-vs-plain EPE mean={float(epe.mean())!r} max={float(epe.max())!r} "
            f"mean|flow|={float(flow_up.abs().mean())!r} launches={launches} "
            f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not float(epe.mean()) < 0.02:
            raise AssertionError("kernel path and plain path disagree")
        del img1, img2, flow_up, flow_plain
        torch.cuda.empty_cache()
    state["standard"] = results
    log("phase standard: ok")


def _train_batch(B, seed):
    """Seeded uniform frames and flow on the card (tools/bench_train.py's data)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, W = TRAIN_HW
    return {
        "image1": torch.rand(B, H, W, 3, device="cuda", generator=g) * 255.0,
        "image2": torch.rand(B, H, W, 3, device="cuda", generator=g) * 255.0,
        "flow": torch.rand(B, H, W, 2, device="cuda", generator=g) * 10.0 - 5.0,
        "valid": torch.ones(B, H, W, device="cuda"),
    }


def _timed_steps(st, batch, n, expect, **kw):
    """n train steps, each on its own clock (host clock around a synchronize),
    launches counted from 0 for each step and held against `expect`."""
    from raft_optical_flow_tpu_torch.train.trainer import raft_train_step

    times, metrics = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        reset_all()
        t0 = time.perf_counter()
        metrics = raft_train_step(st, batch, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        expect_launches(launch_counts(), expect, "train step")
    return times, {k: float(v) for k, v in metrics.items()}


@contextlib.contextmanager
def deterministic(algorithms: bool):
    """cudnn.deterministic on; with `algorithms`, PyTorch's deterministic
    algorithms too (warn_only). Restores both on exit."""
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    if algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = cudnn
        torch.use_deterministic_algorithms(False)


def launch_counts():
    """Launches of every kernel of the port since the last reset_all()."""
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    return {**ck.LAUNCHES, **co.LAUNCHES, **gf.LAUNCHES}


def reset_all():
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    ck.reset_launches()
    co.reset_launches()
    gf.reset_launches()


def expect_launches(got, expect, what):
    """Every kernel launched exactly as `expect` says (absent keys: 0)."""
    want = {k: expect.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _small_step(cfg, stage, ckpt, batch, iters, expect):
    """One RAFT-small train step from the checkpoint: (loss, {name: grad})."""
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state, raft_train_step

    s = create_train_state(cfg, stage, ckpt, "cuda")
    reset_all()
    m = raft_train_step(s, batch, iters=iters)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), expect, f"train step {cfg}")
    return float(m["loss"]), {k: p.grad for k, p in s.model.named_parameters()}


def layer_max_rel(grads, ref_grads):
    """max|d| / max|ref| for each layer (its weight and bias together,
    `utils/grad_check.py`): each layer on its own scale, so fnet, the only
    part the lookup's gradient reaches, is not measured against the update
    block's larger gradient. A conv bias in front of an instance norm has a
    zero gradient up to rounding; its layer's weight gradient gives it its
    scale."""
    from raft_optical_flow_tpu_torch.utils import grad_check

    return grad_check.layer_max_rel(grads, ref_grads)


def gradient_gate(spread, floor=None):
    """Each layer's bound, max(2e-5, 2x the card's spread, 2x a measured
    floor where one is given) (`utils/grad_check.py`)."""
    from raft_optical_flow_tpu_torch.utils import grad_check

    return grad_check.gradient_gate(spread, floor)


def phase_train(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import STANDARD_CURRICULUM, StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    # 1. RAFT-small fp32 (TF32 off), checkpoint weights, the golden pair
    gold = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    ckpt = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    stage = StageConfig(name="smoke-small", stage="chairs", num_steps=100, batch_size=1,
                        lr=1e-4, image_size=(192, 320), small=True)
    iters = int(gold["train_iters"])
    batch = {
        "image1": torch.from_numpy(gold["image1"]).float()[None].cuda(),
        "image2": torch.from_numpy(gold["image2"]).float()[None].cuda(),
        "flow": torch.from_numpy(gold["flow_up"]).cuda(),
        "valid": torch.ones(1, 192, 320, device="cuda"),
    }
    st = create_train_state(RAFTConfig(small=True), stage, ckpt, device="cuda")
    ck.reset_launches()
    with torch.no_grad():
        preds = st.model(batch["image1"], batch["image2"], iters=iters, test_mode=False)
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCHES)
    if launches != {"corr_lookup_level": 4 * iters, "corr_lookup_coarse_fused": 0,
                    "corr_lookup_level_bwd": 0, "corr_lookup_all_levels": 0}:
        raise AssertionError(f"train-mode forward launches {launches}")
    epe = np.linalg.norm(preds[-1].cpu().numpy() - gold["train_pred_last"], axis=-1)
    # one step through the kernels, one through the plain lookup, from the
    # same weights, under cuDNN's and PyTorch's deterministic algorithms
    expect_k = {"corr_lookup_level": 4 * iters, "corr_lookup_level_bwd": 4 * iters}
    with deterministic(algorithms=True):
        loss_k, grads_k = _small_step(RAFTConfig(small=True), stage, ckpt, batch, iters, expect_k)
        loss_p, grads_p = _small_step(RAFTConfig(small=True, corr_impl="plain"), stage, ckpt,
                                      batch, iters, {})
    layer_rel = layer_max_rel(grads_k, grads_p)
    # the same kernel step twice with cudnn.deterministic only: 0 in every
    # layer unless an op of the step adds in a varying order (atomics)
    with deterministic(algorithms=False):
        runs = [_small_step(RAFTConfig(small=True), stage, ckpt, batch, iters, expect_k)[1]
                for _ in range(2)]
    noise = layer_max_rel(runs[1], runs[0])
    fnet = [k for k in grads_p if k.startswith("fnet.")]
    fnet_rel = (max(float((grads_k[k] - grads_p[k]).abs().max()) for k in fnet)
                / max(float(grads_p[k].abs().max()) for k in fnet))
    worst = max(layer_rel, key=layer_rel.get)
    worst_noise = max(noise, key=noise.get)
    log(f"train small fp32: train_iters={iters} preds[-1] EPE vs golden mean={epe.mean()!r} "
        f"max={epe.max()!r}; step kernel-vs-plain loss {loss_k!r} vs {loss_p!r}, "
        f"gradient max_rel per layer: worst {worst} {layer_rel[worst]!r} (gate 2e-5 each), "
        f"fnet as a whole {fnet_rel!r} (deterministic algorithms on for this comparison); "
        f"kernel step vs itself, cudnn.deterministic only: worst {worst_noise} "
        f"{noise[worst_noise]!r} (gate 0.0)")
    log("  gradient max_rel by layer, kernel vs plain: "
        + " ".join(f"{n}={r:.3e}" for n, r in layer_rel.items()))
    if not (epe.mean() < 1e-3 and loss_k == loss_p
            and all(r <= 2e-5 for r in layer_rel.values())):
        raise AssertionError("RAFT-small training does not match the golden or the plain path")
    if any(r != 0.0 for r in noise.values()):
        raise AssertionError("the same RAFT-small kernel step run twice gives other gradients")
    del st, runs, grads_k, grads_p, preds
    torch.cuda.empty_cache()

    # 2. RAFT-standard, bf16 policy, batch 4, 368x496, 12 iterations, frozen BN
    results = {}
    stage = StageConfig(name="smoke-bf16", stage="things", num_steps=100, batch_size=4,
                        lr=1.25e-4, image_size=TRAIN_HW)
    st = create_train_state(RAFTConfig(compute_dtype=torch.bfloat16), stage, device="cuda")
    batch = _train_batch(4, seed=41)
    per_step = {"corr_lookup_level": 4 * TRAIN_ITERS, "corr_lookup_coarse_fused": 0,
                "corr_lookup_level_bwd": 4 * TRAIN_ITERS}
    _timed_steps(st, batch, 1, per_step, iters=TRAIN_ITERS, freeze_bn=True)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    times, m = _timed_steps(st, batch, 5, per_step, iters=TRAIN_ITERS, freeze_bn=True)
    ms = float(np.median(times))
    results["bf16_bs4"] = {"ms": ms, "ms_readings": times, "pairs_per_s": 4e3 / ms,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "launches": per_step, "loss": m["loss"], "grad_norm": m["grad_norm"]}
    r = results["bf16_bs4"]
    log(f"train standard bf16 batch=4 {TRAIN_HW[0]}x{TRAIN_HW[1]} iters={TRAIN_ITERS}: "
        f"{ms:.3f} ms/step (median of {[round(t, 3) for t in times]}) "
        f"{r['pairs_per_s']:.3f} pairs/s peak_mem={r['peak_gib']:.2f} GiB loss={m['loss']!r} "
        f"grad_norm={m['grad_norm']!r} launches/step={per_step}")
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        raise AssertionError("bf16 training step is not finite")
    del st, batch
    torch.cuda.empty_cache()

    # 3. RAFT-standard fp32, the chairs stage: batch 10, BatchNorm training
    chairs = STANDARD_CURRICULUM[0]
    assert chairs.batch_size == 10 and tuple(chairs.image_size) == TRAIN_HW and not chairs.freeze_bn
    st = create_train_state(RAFTConfig(), chairs, device="cuda")
    bn_before = {k: v.clone() for k, v in st.model.state_dict().items() if "running" in k}
    batch = _train_batch(chairs.batch_size, seed=43)
    torch.cuda.reset_peak_memory_stats()
    times, m = _timed_steps(st, batch, 2, per_step, iters=chairs.iters, gamma=chairs.gamma,
                            freeze_bn=chairs.freeze_bn)
    sd = st.model.state_dict()
    moved = sum(not torch.equal(v, sd[k]) for k, v in bn_before.items())
    results["fp32_chairs_bs10"] = {"ms": times[-1], "ms_readings": times,
                                   "pairs_per_s": chairs.batch_size * 1e3 / times[-1],
                                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                   "bn_buffers_moved": moved, "bn_buffers": len(bn_before),
                                   "loss": m["loss"]}
    r = results["fp32_chairs_bs10"]
    log(f"train standard fp32 chairs batch=10 {TRAIN_HW[0]}x{TRAIN_HW[1]} iters={chairs.iters}: "
        f"step ms {[round(t, 3) for t in times]} peak_mem={r['peak_gib']:.2f} GiB "
        f"loss={m['loss']!r} BN buffers moved {moved}/{len(bn_before)}")
    if not (np.isfinite(m["loss"]) and moved == len(bn_before) and len(bn_before) == 30):
        raise AssertionError("chairs-stage step: loss not finite or BN statistics did not move")
    del st, batch
    torch.cuda.empty_cache()
    state["train"] = results
    log("phase train: ok")


# ---------------------------------------------------------------------------
# on-demand correlation (alternate_corr)


def ondemand_inputs(B, h, w, dtype, seed, C=256, levels=4):
    """fmap1 [B, Q, C] and the fmap2 pyramid [B, Hl, Wl, C] from seeded fp32
    fmaps (pooled in fp32, then cast, as the model builds them)."""
    from raft_optical_flow_tpu_torch.ops.corr import avg_pool2x2

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(B, h * w, C, device="cuda", generator=g)
    pyr = [torch.randn(B, h, w, C, device="cuda", generator=g)]
    for _ in range(levels - 1):
        pyr.append(avg_pool2x2(pyr[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    return f1.to(dtype).contiguous(), [f.to(dtype).contiguous() for f in pyr]


def bf16_step(ref):
    """One bf16 rounding step (ulp) at each value of ref."""
    _, e = torch.frexp(ref)
    return torch.where(ref == 0, torch.zeros_like(ref), torch.ldexp(torch.ones_like(ref), e - 8))


def check_k4(name, out, ref32):
    """fp32 windows: max_rel <= 2e-5; bf16 windows: within one bf16 rounding
    step of the plain fp32 value, plus 2e-5 * max|ref| where the C-long sums
    cancel. Returns max|out - round(ref)|."""
    diff = (out.float() - ref32).abs()
    scale = float(ref32.abs().max())
    if out.dtype == torch.float32:
        ok = bool(diff.max() <= 2e-5 * scale)
    else:
        ok = bool((diff <= bf16_step(ref32) + 2e-5 * scale).all())
    if not ok or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: max|diff| {float(diff.max()):.3e} (scale {scale:.3e})")
    return float((out.float() - ref32.to(out.dtype).float()).abs().max())


def check_rel(name, got, ref, tol=2e-5):
    """max|d| / max|ref| <= tol (fp32 gradients: the repo's VJP gate)."""
    if ref.numel() == 0:
        return 0.0, 0.0
    d = float((got - ref).abs().max())
    rel = d / max(float(ref.abs().max()), 1e-30)
    if not rel <= tol or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: max_rel {rel:.3e} (gate {tol})")
    return rel, d


def check_plan(name, coords, shapes, radius):
    """K6's prepass against its plain version: the same row starts and the
    same (query, row) pairs (the kernel leaves the rest of each level's
    entries unwritten). Returns the number of pairs."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    entries, starts = co.corr_ondemand_df2_plan(coords, shapes, radius)
    ref_e, ref_s = co.corr_ondemand_df2_plan_plain(coords, shapes, radius)
    same = torch.equal(starts, ref_s)
    n_pairs = 0
    for lvl, (h, w) in enumerate(shapes):
        for b in range(coords.shape[0]):
            n = int(ref_s[b, lvl, h]) if h > 0 and w > 0 else 0
            same = same and torch.equal(entries[b, lvl, :n], ref_e[b, lvl, :n])
            n_pairs += n
    if not same:
        raise AssertionError(f"K6 prepass {name}: differs from its plain version")
    return n_pairs


def compare_ondemand(f1, levels, coords, radius, tag, err, rels, far_rows=0, w=0):
    """K4, K5 and K6 (and its prepass) against their plain versions on one
    set of inputs; returns the routes K4's tiles took."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    dt = f1.dtype
    out = co.corr_ondemand_fwd(f1, levels, coords, radius, dt)
    routes = co.corr_ondemand_fwd_routes()
    ref = co.corr_ondemand_fwd_plain(f1, levels, coords, radius, torch.float32)
    err["corr_ondemand_fwd"] = max(err["corr_ondemand_fwd"], check_k4(f"K4 {tag}", out, ref))
    if far_rows and bool(out[:, : far_rows * w].ne(0).any()):
        raise AssertionError(f"K4 {tag}: far out-of-bounds windows are not zero")
    if levels[-1].shape[1] == 0 and bool(out[..., -((2 * radius + 1) ** 2):].ne(0).any()):
        raise AssertionError(f"K4 {tag}: the empty level's windows are not zero")
    del ref
    gen = torch.Generator(device="cuda").manual_seed(7 + radius)
    g = torch.randn(out.shape, device="cuda", generator=gen).to(dt)
    df1 = co.corr_ondemand_bwd_df1(levels, coords, g, radius)
    rel, d = check_rel(f"K5 {tag}", df1, co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius))
    err["corr_ondemand_bwd_df1"] = max(err["corr_ondemand_bwd_df1"], d)
    rels["corr_ondemand_bwd_df1"] = max(rels["corr_ondemand_bwd_df1"], rel)
    if far_rows and bool(df1[:, : far_rows * w].ne(0).any()):
        raise AssertionError(f"K5 {tag}: far out-of-bounds queries got a gradient")
    del df1
    shapes = [tuple(f.shape[1:3]) for f in levels]
    check_plan(tag, coords, shapes, radius)
    df2 = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius)
    again = co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius)
    if not all(torch.equal(a, b) for a, b in zip(df2, again)):
        raise AssertionError(f"K6 {tag}: two runs differ")
    del again
    for lvl, (a, b) in enumerate(zip(df2, co.corr_ondemand_bwd_df2_plain(f1, coords, g, shapes,
                                                                          radius))):
        if a.shape != b.shape:
            raise AssertionError(f"K6 {tag} l{lvl}: shape {tuple(a.shape)}")
        rel, d = check_rel(f"K6 {tag} l{lvl}", a, b)
        err["corr_ondemand_bwd_df2"] = max(err["corr_ondemand_bwd_df2"], d)
        rels["corr_ondemand_bwd_df2"] = max(rels["corr_ondemand_bwd_df2"], rel)
    torch.cuda.synchronize()
    return routes


def _ondemand_kernel_checks(state):
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    err = {k: 0.0 for k in co.LAUNCHES}
    rels = {"corr_ondemand_bwd_df1": 0.0, "corr_ondemand_bwd_df2": 0.0}
    n = 0
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8  # 55 x 128
    # the serving shapes: batch 16, RAFT-standard (C = 256, r = 4) under the
    # bf16 policy, with far out-of-bounds and border-straddling queries; and
    # RAFT-small's width and radius (C = 128, r = 3) in fp32 at batch 2
    for B, C, radius, dt in ((16, 256, 4, torch.bfloat16), (2, 128, 3, torch.float32)):
        f1, levels = ondemand_inputs(B, h, w, dt, seed=70 + radius, C=C)
        assert [tuple(f.shape[1:3]) for f in levels] == [(55, 128), (27, 64), (13, 32), (6, 16)]
        coords = serving_coords(B, h, w, seed=71 + radius)
        coords[:, :2] += 1.0e6
        coords[:, 2:4] -= 1.0e6
        coords[:, 4:6, :, 0] = w + radius - 0.5
        routes = compare_ondemand(f1, levels, coords.reshape(B, h * w, 2).contiguous(), radius,
                                  f"serve B={B} C={C} r={radius} {dt}", err, rels, far_rows=4,
                                  w=w)
        log(f"  K4 routes, serve B={B} C={C} r={radius} {dt}: {routes}")
        n += 1
        del f1, levels, coords
        torch.cuda.empty_cache()
    # the training shapes (368x496: levels 46x62 .. 5x7, r = 4): batch 4 bf16
    # and batch 10 fp32
    th, tw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    for B, dt in ((4, torch.bfloat16), (10, torch.float32)):
        f1, levels = ondemand_inputs(B, th, tw, dt, seed=80 + B)
        assert [tuple(f.shape[1:3]) for f in levels] == [(46, 62), (23, 31), (11, 15), (5, 7)]
        coords = serving_coords(B, th, tw, seed=81 + B).reshape(B, th * tw, 2).contiguous()
        routes = compare_ondemand(f1, levels, coords, 4, f"train B={B} {dt}", err, rels)
        log(f"  K4 routes, train B={B} {dt}: {routes}")
        n += 1
        del f1, levels, coords
        torch.cuda.empty_cache()
    # a 56x128 frame: levels 7x16, 3x8, 1x4, 0x2 (the deepest is empty)
    for C, radius, dt in ((128, 3, torch.float32), (128, 3, torch.bfloat16),
                          (256, 4, torch.float32)):
        f1, levels = ondemand_inputs(2, 7, 16, dt, seed=90 + radius, C=C)
        assert levels[-1].shape[1] == 0
        coords = serving_coords(2, 7, 16, seed=91).reshape(2, 112, 2).contiguous()
        compare_ondemand(f1, levels, coords, radius, f"empty-level C={C} r={radius} {dt}",
                         err, rels)
        n += 1
    state["ondemand_max_abs_err"] = err
    log(f"ondemand kernels: max_abs_err {err!r} max_rel K5 "
        f"{rels['corr_ondemand_bwd_df1']!r} K6 {rels['corr_ondemand_bwd_df2']!r} over {n} "
        f"input sets (gates: K4 fp32 max_rel 2e-5, bf16 one bf16 step + 2e-5*max|ref|; "
        f"K5, K6 max_rel 2e-5; K6 twice bit for bit; prepass equal) "
        f"launches={dict(co.LAUNCHES)}")


def _ondemand_serving(state):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig

    bf16 = torch.bfloat16
    model = RAFT(RAFTConfig(alternate_corr=True, compute_dtype=bf16), device="cuda",
                 generator=torch.Generator().manual_seed(0))
    results = {}
    # batch 16: against the materialized kernel path (same weights)
    mat = RAFT(RAFTConfig(compute_dtype=bf16), device="cuda")
    mat.load_state_dict(model.state_dict())
    padder, img1, img2 = _serving_inputs(16, seed=16)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, flow_mat = mat(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    peak_mat = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all()
    _, flow = model(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    launches = launch_counts()  # the main path's run
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_launches(launches, {"corr_ondemand_fwd": ITERS}, "on-demand serving")
    out = padder.unpad(flow)
    if tuple(out.shape) != (16, *SERVE_HW, 2) or not torch.isfinite(out).all():
        raise AssertionError("on-demand RAFT-standard output has the wrong shape or is not finite")
    epe = torch.linalg.norm(flow - flow_mat, dim=-1)
    times = {"ondemand": [], "materialized": []}
    for _ in range(2):  # in turns: on-demand, materialized
        for name, m in (("ondemand", model), ("materialized", mat)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m(img1, img2, iters=ITERS)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms = min(times["ondemand"])
    results[16] = {"ms": ms, "ms_readings": times["ondemand"], "pairs_per_s": 16e3 / ms,
                   "materialized_ms_readings": times["materialized"], "peak_gib": peak,
                   "materialized_peak_gib": peak_mat, "launches": launches,
                   "epe_mean": float(epe.mean()), "epe_max": float(epe.max())}
    log(f"ondemand standard bf16 batch=16: {ms:.3f} ms/call {16e3 / ms:.3f} pairs/s (readings "
        f"{[round(t, 3) for t in times['ondemand']]}; materialized "
        f"{[round(t, 3) for t in times['materialized']]}) vs materialized kernel path EPE "
        f"mean={float(epe.mean())!r} max={float(epe.max())!r} (gate mean < 0.02) "
        f"peak_mem={peak:.2f} GiB (materialized {peak_mat:.2f} GiB) launches={launches}")
    if not float(epe.mean()) < 0.02:
        raise AssertionError("on-demand and materialized serving disagree")
    del mat, img1, img2, flow, flow_mat, out
    torch.cuda.empty_cache()
    # batch 1: the kernel path against the plain on-demand path
    plain = RAFT(RAFTConfig(alternate_corr=True, compute_dtype=bf16, corr_impl="plain"),
                 device="cuda")
    plain.load_state_dict(model.state_dict())
    padder, img1, img2 = _serving_inputs(1, seed=1)
    reset_all()
    _, flow = model(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {"corr_ondemand_fwd": ITERS}, "on-demand serving batch 1")
    _, flow_plain = plain(img1, img2, iters=ITERS)
    epe = torch.linalg.norm(flow - flow_plain, dim=-1)
    t0 = time.perf_counter()
    for _ in range(4):
        model(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 4
    results[1] = {"ms": ms, "pairs_per_s": 1e3 / ms, "epe_mean": float(epe.mean()),
                  "epe_max": float(epe.max())}
    log(f"ondemand standard bf16 batch=1: {ms:.3f} ms/call, kernel vs plain on-demand EPE "
        f"mean={float(epe.mean())!r} max={float(epe.max())!r} (gate mean < 0.02)")
    if not float(epe.mean()) < 0.02:
        raise AssertionError("on-demand kernel path and plain path disagree")
    state["ondemand_serving"] = results


def _ondemand_small(state):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    model = RAFT(RAFTConfig(small=True, alternate_corr=True), device="cuda")
    model.load_state_dict(load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz")))
    img1 = torch.from_numpy(g["image1"]).float()[None].cuda()
    img2 = torch.from_numpy(g["image2"]).float()[None].cuda()
    iters = int(g["iters"])
    reset_all()
    flow_low, flow_up = model(img1, img2, iters=iters)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {"corr_ondemand_fwd": iters}, "on-demand RAFT-small")
    low_err = np.abs(flow_low.cpu().numpy() - g["flow_low"]).max()
    epe = np.linalg.norm(flow_up.cpu().numpy() - g["flow_up"], axis=-1)
    log(f"ondemand small fp32: iters={iters} flow_low max|d|={low_err!r} flow_up EPE vs golden "
        f"mean={epe.mean()!r} max={epe.max()!r} (gates 2e-3, 1e-3, 5e-3)")
    if not (low_err <= 2e-3 and epe.mean() < 1e-3 and epe.max() < 5e-3):
        raise AssertionError("on-demand RAFT-small does not match the golden")


def _ondemand_train(state):
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    # RAFT-small fp32: one step through K4-K6 against one through the plain
    # versions (deterministic algorithms on, as in phase train), then the
    # kernel step twice with cudnn.deterministic only
    gold = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    ckpt = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    stage = StageConfig(name="smoke-small", stage="chairs", num_steps=100, batch_size=1,
                        lr=1e-4, image_size=(192, 320), small=True)
    iters = int(gold["train_iters"])
    batch = {
        "image1": torch.from_numpy(gold["image1"]).float()[None].cuda(),
        "image2": torch.from_numpy(gold["image2"]).float()[None].cuda(),
        "flow": torch.from_numpy(gold["flow_up"]).cuda(),
        "valid": torch.ones(1, 192, 320, device="cuda"),
    }
    cfg = RAFTConfig(small=True, alternate_corr=True)
    expect = {"corr_ondemand_fwd": iters, "corr_ondemand_bwd_df1": iters,
              "corr_ondemand_bwd_df2": iters, "corr_ondemand_df2_plan": iters}
    with deterministic(algorithms=True):
        loss_k, grads_k = _small_step(cfg, stage, ckpt, batch, iters, expect)
        loss_p, grads_p = _small_step(dataclasses.replace(cfg, corr_impl="plain"), stage, ckpt,
                                      batch, iters, {})
    layer_rel = layer_max_rel(grads_k, grads_p)
    with deterministic(algorithms=False):
        runs = [_small_step(cfg, stage, ckpt, batch, iters, expect)[1] for _ in range(2)]
    noise = layer_max_rel(runs[1], runs[0])
    worst = max(layer_rel, key=layer_rel.get)
    worst_noise = max(noise, key=noise.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"ondemand train small fp32: step kernel-vs-plain loss {loss_k!r} vs {loss_p!r} "
        f"(rel {loss_rel!r}, gate 1e-5), gradient max_rel per layer: worst {worst} "
        f"{layer_rel[worst]!r} (gate 2e-5 each); kernel step vs itself, cudnn.deterministic "
        f"only: worst {worst_noise} {noise[worst_noise]!r} (gate 0.0); launches/step {expect}")
    log("  gradient max_rel by layer, K4-K6 vs plain: "
        + " ".join(f"{n}={r:.3e}" for n, r in layer_rel.items()))
    if not (loss_rel <= 1e-5 and all(r <= 2e-5 for r in layer_rel.values())):
        raise AssertionError("on-demand RAFT-small training does not match the plain path")
    if any(r != 0.0 for r in noise.values()):
        raise AssertionError("the same on-demand RAFT-small step run twice gives other gradients")
    del runs, grads_k, grads_p
    torch.cuda.empty_cache()

    # RAFT-standard, bf16 policy, batch 4, 368x496, 12 iterations, frozen BN,
    # remat off and on (the JAX package's recommended training configuration)
    stage = StageConfig(name="smoke-bf16", stage="things", num_steps=100, batch_size=4,
                        lr=1.25e-4, image_size=TRAIN_HW)
    batch = _train_batch(4, seed=41)
    results = {}
    for remat in (False, True):
        st = create_train_state(RAFTConfig(compute_dtype=torch.bfloat16, alternate_corr=True,
                                           remat=remat), stage, device="cuda")
        per_step = {"corr_ondemand_fwd": TRAIN_ITERS * (2 if remat else 1),
                    "corr_ondemand_bwd_df1": TRAIN_ITERS, "corr_ondemand_bwd_df2": TRAIN_ITERS,
                    "corr_ondemand_df2_plan": TRAIN_ITERS}
        _timed_steps(st, batch, 1, per_step, iters=TRAIN_ITERS, freeze_bn=True)  # warm-up
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times, m = _timed_steps(st, batch, 5, per_step, iters=TRAIN_ITERS, freeze_bn=True)
        ms = float(np.median(times))
        key = "bf16_bs4_remat" if remat else "bf16_bs4"
        results[key] = {"ms": ms, "ms_readings": times, "pairs_per_s": 4e3 / ms,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "launches": per_step, "loss": m["loss"], "grad_norm": m["grad_norm"]}
        r = results[key]
        log(f"ondemand train standard bf16 batch=4 {TRAIN_HW[0]}x{TRAIN_HW[1]} "
            f"iters={TRAIN_ITERS} remat={remat}: {ms:.3f} ms/step (median of "
            f"{[round(t, 3) for t in times]}) {r['pairs_per_s']:.3f} pairs/s "
            f"peak_mem={r['peak_gib']:.2f} GiB (materialized, phase train: "
            f"{state.get('train', {}).get('bf16_bs4', {}).get('peak_gib', float('nan')):.2f} GiB) "
            f"loss={m['loss']!r} grad_norm={m['grad_norm']!r} launches/step={per_step}")
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError("on-demand bf16 training step is not finite")
        del st
        torch.cuda.empty_cache()
    state["ondemand_train"] = results


def _ondemand_fp32_serving(state):
    """RAFT-standard fp32 on-demand serving at batch 1 (1024x436 padded to
    1024x440, 32 iterations): one Sintel pair of `evaluate --alternate_corr`,
    through K4's fp32 route, against the materialized fp32 path (same
    weights). The host clock over 4 calls after the counted one."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig

    model = RAFT(RAFTConfig(alternate_corr=True), device="cuda",
                 generator=torch.Generator().manual_seed(0))
    mat = RAFT(RAFTConfig(), device="cuda")
    mat.load_state_dict(model.state_dict())
    padder, img1, img2 = _serving_inputs(1, seed=1)
    reset_all()
    _, flow = model(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    launches = launch_counts()  # the main path's run
    expect_launches(launches, {"corr_ondemand_fwd": ITERS}, "on-demand fp32 serving batch 1")
    routes = co.corr_ondemand_fwd_routes()
    out = padder.unpad(flow)
    if tuple(out.shape) != (1, *SERVE_HW, 2) or not torch.isfinite(out).all():
        raise AssertionError("on-demand fp32 RAFT-standard output has the wrong shape or is not "
                             "finite")
    _, flow_mat = mat(img1, img2, iters=ITERS)
    epe = torch.linalg.norm(flow - flow_mat, dim=-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        model(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 4
    state["ondemand_fp32_serving"] = {
        "ms": ms, "pairs_per_s": 1e3 / ms, "launches": launches, "routes_last_call": routes,
        "epe_mean": float(epe.mean()), "epe_max": float(epe.max())}
    log(f"ondemand standard fp32 batch=1: {ms:.3f} ms/call, K4 launches "
        f"{launches['corr_ondemand_fwd']}, routes of the last K4 call {routes}; vs materialized "
        f"fp32 EPE mean={float(epe.mean())!r} max={float(epe.max())!r} (gate mean < 0.02)")
    if not float(epe.mean()) < 0.02:
        raise AssertionError("on-demand fp32 serving and materialized fp32 serving disagree")
    del model, mat, img1, img2, flow, flow_mat, out
    torch.cuda.empty_cache()


def _ondemand_fp32_train(state):
    """The fp32 on-demand chairs step (RAFT-standard, batch 10, 368x496, 12
    iterations, BatchNorm training, `train_raft --alternate_corr`): one
    warm-up, then 3 timed steps; ms/step, peak memory, K4-K6 launches."""
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import STANDARD_CURRICULUM
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state

    chairs = STANDARD_CURRICULUM[0]
    assert chairs.batch_size == 10 and tuple(chairs.image_size) == TRAIN_HW and not chairs.freeze_bn
    st = create_train_state(RAFTConfig(alternate_corr=True), chairs, device="cuda")
    batch = _train_batch(chairs.batch_size, seed=44)
    per_step = {k: chairs.iters for k in ("corr_ondemand_fwd", "corr_ondemand_bwd_df1",
                                         "corr_ondemand_bwd_df2", "corr_ondemand_df2_plan")}
    kw = dict(iters=chairs.iters, gamma=chairs.gamma, freeze_bn=chairs.freeze_bn)
    _timed_steps(st, batch, 1, per_step, **kw)  # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, m = _timed_steps(st, batch, 3, per_step, **kw)
    ms = float(np.median(times))
    state["ondemand_fp32_train"] = {
        "ms": ms, "ms_readings": times, "pairs_per_s": chairs.batch_size * 1e3 / ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": per_step,
        "loss": m["loss"]}
    r = state["ondemand_fp32_train"]
    log(f"ondemand train standard fp32 chairs batch=10 {TRAIN_HW[0]}x{TRAIN_HW[1]} "
        f"iters={chairs.iters}: {ms:.3f} ms/step (median of {[round(t, 3) for t in times]}) "
        f"peak_mem={r['peak_gib']:.2f} GiB (materialized, phase train: "
        f"{state.get('train', {}).get('fp32_chairs_bs10', {}).get('peak_gib', float('nan')):.2f}"
        f" GiB) loss={m['loss']!r} launches/step={per_step}")
    if not np.isfinite(m["loss"]):
        raise AssertionError("on-demand fp32 chairs step is not finite")
    del st, batch
    torch.cuda.empty_cache()


def phase_ondemand(state):
    _ondemand_kernel_checks(state)
    _ondemand_serving(state)
    _ondemand_fp32_serving(state)
    _ondemand_small(state)
    _ondemand_train(state)
    _ondemand_fp32_train(state)
    log("phase ondemand: ok")


# ---------------------------------------------------------------------------
# fused SepConvGRU (fused_gru)


def gru_inputs(B, H, W, dtype, seed, X=256, D=128):
    """h (tanh of normals) and x (relu of normals) NHWC on the card, and the
    six gates' (weight OIHW, bias) at PyTorch's default conv init bound."""
    from raft_optical_flow_tpu_torch.kernels.gru_fused import GATES

    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.tanh(torch.randn(B, H, W, D, device="cuda", generator=g)).to(dtype)
    x = torch.relu(torch.randn(B, H, W, X, device="cuda", generator=g)).to(dtype)
    bound = (5 * (D + X)) ** -0.5
    weights = []
    for name in GATES:
        ks = (1, 5) if name.endswith("1") else (5, 1)
        weights.append((torch.rand(D, D + X, *ks, device="cuda", generator=g) * 2 - 1) * bound)
        weights.append((torch.rand(D, device="cuda", generator=g) * 2 - 1) * bound)
    return h, x, weights


def check_k7(name, got, ref, w):
    """K7 against its plain version on one pass's inputs. fp32: max_rel <=
    1e-5. bf16: within one bf16 rounding step of the plain value, plus what one
    flipped rounding of r*h carries through the q gate (a bf16 step of |rh| <
    1, 2^-8, times the largest q weight), plus 2e-5 * max|ref| for the sums'
    order (K4's term). Returns (max|d|, max_rel, elements past one step, the
    largest distance past it)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"K7 {name}: {got.dtype} {tuple(got.shape)}")
    g32, r32 = got.float(), ref.float()
    d = (g32 - r32).abs()
    scale = float(r32.abs().max())
    rel = float(d.max()) / scale
    if got.dtype == torch.float32:
        ok = rel <= 1e-5
        past, excess = 0, 0.0
    else:
        slack = 2.0**-8 * float(w[:, :, 2 * w.shape[2] // 3:].float().abs().max()) + 2e-5 * scale
        step = bf16_step(r32)
        ok = bool((d <= step + slack).all())
        past, excess = int((d > step).sum()), max(float((d - step).max()), 0.0)
    if not ok or not torch.isfinite(g32).all():
        raise AssertionError(f"K7 {name}: max|d| {float(d.max()):.3e} max_rel {rel:.3e}")
    return float(d.max()), rel, past, excess


def _k7_kernel_checks(state):
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    err, lines = 0.0, []
    # serving (RAFT-standard bf16 at 1024x440, batch 16), training (fp32
    # chairs-size crop, batch 4 and 2), 37-long rows (fp32: blocks of rows
    # across lines; two bf16 rows to a block), the 1-high and 1-wide levels
    # where each tap but the centre is padding in one of the passes, and
    # 300-long rows (bf16: segments of 124 with a 2-position halo); each pass
    # held on the plain version's own input
    for B, H, W, dt in ((16, 55, 128, torch.bfloat16), (4, 46, 62, torch.float32),
                        (2, 46, 62, torch.float32),
                        (1, 8, 37, torch.float32), (1, 8, 37, torch.bfloat16),
                        (2, 1, 37, torch.bfloat16), (2, 37, 1, torch.float32),
                        (1, 3, 300, torch.bfloat16)):
        h, x, weights = gru_inputs(B, H, W, dt, seed=B * 1000 + H * W)
        for axis, part in ((2, weights[:6]), (1, weights[6:])):
            w, b = gf.pass_weights(part, dt)
            got = gf.gru_pass(h, x, w, b, axis)
            ref = gf.gru_pass_plain(h, x, w, b, axis)
            d, rel, past, excess = check_k7(f"B={B} {H}x{W} {dt} axis={axis}", got, ref, w)
            err = max(err, d)
            lines.append(f"{B}x{H}x{W} {str(dt)[6:]} {'1x5' if axis == 2 else '5x1'}: max|d| "
                         f"{d:.3e} max_rel {rel:.3e} past one step {past}/{got.numel()} "
                         f"by at most {excess:.3e}")
            h = ref
        del h, x, got, ref
    torch.cuda.synchronize()
    state["fused_max_abs_err"] = err
    log("fused_gru K7 vs plain (gates: fp32 max_rel 1e-5; bf16 one rounding step + 2^-8 * "
        "max|W_q| + 2e-5 * max|ref|): " + "; ".join(lines))


def _fused_serving(state):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig

    results = {}
    for dt, batches in ((torch.bfloat16, (16, 1)), (torch.float32, (1,))):
        unfused = RAFT(RAFTConfig(compute_dtype=dt), device="cuda",
                       generator=torch.Generator().manual_seed(0))
        fused = RAFT(RAFTConfig(compute_dtype=dt, fused_gru=True), device="cuda")
        fused.load_state_dict(unfused.state_dict())
        for B in batches:
            padder, img1, img2 = _serving_inputs(B, seed=100 + B)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _, flow_ref = unfused(img1, img2, iters=ITERS)
            torch.cuda.synchronize()
            peak_ref = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_all()
            _, flow = fused(img1, img2, iters=ITERS)
            torch.cuda.synchronize()
            launches = launch_counts()  # the main path's run
            peak = torch.cuda.max_memory_allocated() / 2**30
            expect_launches(launches, {"sepconv_gru_pass": 2 * ITERS, "corr_lookup_level": ITERS,
                                       "corr_lookup_coarse_fused": ITERS}, f"fused serving B={B}")
            out = padder.unpad(flow)
            if tuple(out.shape) != (B, *SERVE_HW, 2) or not torch.isfinite(out).all():
                raise AssertionError("fused RAFT-standard output: wrong shape or not finite")
            epe = torch.linalg.norm(flow - flow_ref, dim=-1)
            times = {"fused": [], "unfused": []}
            for _ in range(2):  # in turns: fused, unfused
                for name, m in (("fused", fused), ("unfused", unfused)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m(img1, img2, iters=ITERS)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
            ms, ms_ref = min(times["fused"]), min(times["unfused"])
            key = f"{str(dt)[6:]}_bs{B}"
            results[key] = {"ms": ms, "ms_readings": times["fused"], "pairs_per_s": B * 1e3 / ms,
                            "unfused_ms": ms_ref, "unfused_ms_readings": times["unfused"],
                            "unfused_pairs_per_s": B * 1e3 / ms_ref, "peak_gib": peak,
                            "unfused_peak_gib": peak_ref, "launches": launches,
                            "epe_mean": float(epe.mean()), "epe_max": float(epe.max())}
            gate = "mean < 0.02" if dt == torch.bfloat16 else "mean < 1e-3, max < 5e-3"
            log(f"fused_gru standard {str(dt)[6:]} batch={B}: {ms:.3f} ms/call "
                f"{B * 1e3 / ms:.3f} pairs/s (readings {[round(t, 3) for t in times['fused']]}); "
                f"unfused {ms_ref:.3f} ms/call {B * 1e3 / ms_ref:.3f} pairs/s (readings "
                f"{[round(t, 3) for t in times['unfused']]}); vs unfused EPE "
                f"mean={float(epe.mean())!r} max={float(epe.max())!r} (gate {gate}); "
                f"peak_mem {peak:.2f} GiB (unfused {peak_ref:.2f}) launches={launches}")
            ok = (float(epe.mean()) < 0.02 if dt == torch.bfloat16
                  else float(epe.mean()) < 1e-3 and float(epe.max()) < 5e-3)
            if not ok:
                raise AssertionError(f"fused and unfused {dt} serving disagree")
            del img1, img2, flow, flow_ref, out
        del fused, unfused
        torch.cuda.empty_cache()
    state["fused_serving"] = results


def _fused_train(state):
    """The fp32 fused training step against the unfused one (same weights and
    batch, PyTorch's deterministic algorithms on) at GATE_ITERS, 3 and
    TRAIN_ITERS iterations. Beside each, the step's own floor: per layer, the
    larger reading of the unfused step with its GRU weights x (1 + 1e-7) and
    x (1 - 1e-7) (one fp32 rounding step, less than the ~1e-6 by which K7's
    and cuDNN's sums differ) against the unfused step. The step is not
    smooth at that scale: ReLU inputs within 1e-7 of zero flip, and fnet's
    first layers' weight gradients are sums with heavy cancellation, so
    some layers move by far more than VJP_TOL whatever computed the forward
    (tools/port_grad_sensitivity.py). At GATE_ITERS the loss is gated at rel
    1e-5 and each layer at max(VJP_TOL, 2 x its floor), twice the floor for
    the spread between two draws of the same noise; deeper readings are
    reported. The fused step run twice with cudnn.deterministic only is
    gated at 0.0."""
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state, raft_train_step

    stage = StageConfig(name="smoke-fused", stage="things", num_steps=100, batch_size=2,
                        lr=1.25e-4, image_size=TRAIN_HW)
    batch = _train_batch(2, seed=47)

    def step(fused, iters, scale_gru=1.0):
        st = create_train_state(RAFTConfig(fused_gru=fused), stage, device="cuda")
        if scale_gru != 1.0:
            with torch.no_grad():
                for p in st.model.update_block.gru.parameters():
                    p.mul_(scale_gru)
        expect = {"corr_lookup_level": 4 * iters, "corr_lookup_level_bwd": 4 * iters}
        if fused:
            expect["sepconv_gru_pass"] = 2 * iters
        reset_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = raft_train_step(st, batch, iters=iters, freeze_bn=True)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        expect_launches(launch_counts(), expect, f"train step fused_gru={fused} iters={iters}")
        return float(m["loss"]), {k: p.grad for k, p in st.model.named_parameters()}, ms

    readings, ms = {}, {}
    with deterministic(algorithms=True):
        for iters in (GATE_ITERS, 3, TRAIN_ITERS):
            loss_f, grads_f, ms_f = step(True, iters)
            loss_u, grads_u, ms_u = step(False, iters)
            floors = [layer_max_rel(step(False, iters, scale_gru=1 + e)[1], grads_u)
                      for e in (1e-7, -1e-7)]
            readings[iters] = {"loss_rel": abs(loss_f - loss_u) / abs(loss_u),
                               "vs_unfused": layer_max_rel(grads_f, grads_u),
                               "floor": {n: max(f[n] for f in floors) for n in floors[0]}}
            ms[iters] = (ms_f, ms_u)
            del grads_f, grads_u, floors
    # the fused step run twice with cudnn.deterministic only
    with deterministic(algorithms=False):
        runs = [step(True, TRAIN_ITERS)[1] for _ in range(2)]
    noise = layer_max_rel(runs[1], runs[0])
    del runs
    # the bf16 policy has no fused training semantics: it must refuse
    try:
        st = create_train_state(RAFTConfig(fused_gru=True, compute_dtype=torch.bfloat16), stage,
                                device="cuda")
        raft_train_step(st, batch, iters=TRAIN_ITERS, freeze_bn=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    state["fused_train"] = {"readings": readings, "ms": ms}

    def worst(rel):
        name = max(rel, key=rel.get)
        return f"{name} {rel[name]!r}"

    for iters, r in readings.items():
        gate = (" (gates: loss rel 1e-5, per layer max(2e-5, 2 x floor))" if iters == GATE_ITERS
                else " (reported)")
        log(f"fused_gru train fp32 batch=2 {TRAIN_HW[0]}x{TRAIN_HW[1]} iters={iters} "
            f"(deterministic algorithms on){gate}: fused vs unfused loss rel {r['loss_rel']!r}, "
            f"gradient max_rel worst layer {worst(r['vs_unfused'])}; floor (unfused, GRU "
            f"weights x (1 +- 1e-7)) worst {worst(r['floor'])}; step ms fused "
            f"{ms[iters][0]:.3f} unfused {ms[iters][1]:.3f} (first steps, not timings)")
        for name in ("vs_unfused", "floor"):
            log(f"  gradient max_rel by layer, {name}: "
                + " ".join(f"{n}={v:.3e}" for n, v in r[name].items()))
    log(f"fused_gru train fp32 iters={TRAIN_ITERS}: fused step vs itself, cudnn.deterministic "
        f"only: worst {worst(noise)} (gate 0.0); bf16 fused step refused: {refused is not None}")
    gated = readings[GATE_ITERS]
    if not gated["loss_rel"] <= 1e-5:
        raise AssertionError("fused and unfused training losses disagree")
    bad = {n: (v, gated["floor"][n]) for n, v in gated["vs_unfused"].items()
           if not v <= max(VJP_TOL[torch.float32], 2 * gated["floor"][n])}
    if bad:
        raise AssertionError(f"fused and unfused training gradients disagree "
                             f"(layer: reading, floor): {bad}")
    if any(v != 0.0 for v in noise.values()):
        raise AssertionError("the same fused step run twice gives other gradients")
    if refused is None or "ROADMAP.md Queue 3" not in refused:
        raise AssertionError("bf16 fused training was not refused with a ValueError")
    torch.cuda.empty_cache()


def _fused_ondemand(state):
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig

    model = RAFT(RAFTConfig(compute_dtype=torch.bfloat16, alternate_corr=True, fused_gru=True),
                 device="cuda", generator=torch.Generator().manual_seed(0))
    padder, img1, img2 = _serving_inputs(1, seed=1)
    reset_all()
    _, flow = model(img1, img2, iters=ITERS)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(launches, {"corr_ondemand_fwd": ITERS, "sepconv_gru_pass": 2 * ITERS},
                    "alternate_corr with fused_gru")
    if not torch.isfinite(flow).all():
        raise AssertionError("alternate_corr with fused_gru: output not finite")
    log(f"fused_gru with alternate_corr bf16 batch=1: launches={launches}")


def phase_fused_gru(state):
    _k7_kernel_checks(state)
    _fused_serving(state)
    _fused_train(state)
    _fused_ondemand(state)
    log("phase fused_gru: ok")


# ---------------------------------------------------------------------------
# The plain-PyTorch families (LiteFlowNet3, SimpleFlowNet, IFNet): shared timing

FAMILY_TRAIN_HW = (384, 768)  # cli/train_flow.py's crop and batch defaults
FAMILY_TRAIN_B = 8


def _median_ms(fn, n_timed=5):
    """fn() once to warm up, then n_timed timed calls, each between two CUDA
    events after a synchronize (`utils/profiling.py::time_calls`): (the
    warm-up's output, median ms, every ms, peak GiB since the warm-up
    began)."""
    from raft_optical_flow_tpu_torch.utils.profiling import time_calls

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, out = time_calls(fn, num_reps=n_timed, warmup=1, device="cuda")
    return out, float(np.median(times)), [round(t, 3) for t in times], \
        torch.cuda.max_memory_allocated() / 2**30


def _step_grads(model, loss_fn, inputs):
    """One forward, loss and backward (no optimizer): (loss, {name: grad})."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, *inputs)
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _gradient_rows(tag, cases, n_timed=3):
    """cases: (key, make_model(device), loss_fn(model, img1, img2, gt, valid)).
    Each: ms per forward+backward and peak memory at batch 8, 384x768; at
    batch 2, 64x96 the card's loss (rel 1e-5) and each layer's gradient
    against the port on the CPU, within max(2e-5, 2x the spread of the
    card's step run twice: atomic adds in PyTorch's backward of the
    gathers and resizes)."""
    out = {}
    for key, make, loss_fn in cases:
        B, (H, W) = FAMILY_TRAIN_B, FAMILY_TRAIN_HW
        g = torch.Generator(device="cuda").manual_seed(3)
        big = [torch.rand(B, H, W, 3, device="cuda", generator=g),
               torch.rand(B, H, W, 3, device="cuda", generator=g),
               torch.rand(B, H, W, 2, device="cuda", generator=g) * 10.0 - 5.0,
               torch.ones(B, H, W, device="cuda")]
        model = make("cuda")
        _, ms, ms_all, peak = _median_ms(lambda: _step_grads(model, loss_fn, big), n_timed)
        del big
        torch.cuda.empty_cache()

        rng = np.random.RandomState(0)
        small = [torch.from_numpy(a) for a in (
            rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32),
            rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32),
            rng.uniform(-5, 5, (2, 64, 96, 2)).astype(np.float32),
            (rng.rand(2, 64, 96) > 0.2).astype(np.float32))]
        loss1, g1 = _step_grads(model, loss_fn, [t.cuda() for t in small])
        loss2, g2 = _step_grads(model, loss_fn, [t.cuda() for t in small])
        cpu_loss, cpu_grads = _step_grads(make("cpu"), loss_fn, small)
        spread = layer_max_rel(g2, g1)
        rels = layer_max_rel({k: v.cpu() for k, v in g1.items()}, cpu_grads)
        loss_rel = abs(loss1 - cpu_loss) / abs(cpu_loss)
        gate = gradient_gate(spread)
        bad = {n: r for n, r in rels.items() if not r <= gate[n]}
        worst = max(rels, key=rels.get)
        out[key] = {"ms": ms, "ms_all": ms_all, "peak_gib": peak, "loss_rel": loss_rel,
                    "worst_layer": worst, "worst_rel": rels[worst],
                    "spread_max": max(spread.values()), "twice_loss_equal": loss1 == loss2}
        log(f"{tag} grad {key} fp32 batch={B} {H}x{W}: {ms:.3f} ms per forward+backward "
            f"(median of {n_timed}: {ms_all}) peak_mem={peak:.3f} GiB; batch 2 64x96 card vs "
            f"CPU: loss rel={loss_rel!r} worst layer {worst} max_rel={rels[worst]!r}; card "
            f"twice: loss equal={loss1 == loss2} worst spread={max(spread.values())!r} "
            f"({max(spread, key=spread.get)})")
        if not loss_rel <= 1e-5 or bad:
            raise AssertionError(f"{tag} {key} gradients: loss rel {loss_rel!r}, layers past "
                                 f"max(2e-5, 2x spread): {bad}")
        del model
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# LiteFlowNet3 (plain PyTorch: no port kernel lies on its path)

LFN3_VARIANTS = {
    "standard": {},
    "s": {"use_s_version": True},
    "standard_pseudoreg": {"use_pseudo_regularization": True},
    "s_pseudoreg": {"use_s_version": True, "use_pseudo_regularization": True},
}
LFN3_SERVE_HW = (436, 1024)  # tools/bench_families.py: Sintel frames, scaled to 448x1024 inside
LFN3_TRAIN_HW = (384, 768)  # cli/train_flow.py's crop and batch defaults
LFN3_TRAIN_B = 8
LFN3_FLOW_TOL = 1e-4  # card against the port on the CPU: the port-vs-JAX bar


def _lfn3_state_dict(variant, goldens):
    """The variant's weights from the goldens: each from the golden of the
    nearer variant that has its name and shape (the two goldens cover every
    name of the four variants)."""
    from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3

    kw = LFN3_VARIANTS[variant]
    first = "s_pseudoreg" if kw.get("use_s_version") else "standard"
    order = [goldens[first]] + [g for n, g in goldens.items() if n != first]
    shapes = LiteFlowNet3(LFN3Config(**kw), device="cpu").state_dict()
    return {k: next(g[k] for g in order if k in g and g[k].shape == v.shape)
            for k, v in shapes.items()}


def _lfn3(variant, sd, device="cuda", dtype=torch.float32):
    from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3

    model = LiteFlowNet3(LFN3Config(compute_dtype=dtype, **LFN3_VARIANTS[variant]), device=device)
    model.load_state_dict(sd)
    return model


def _lfn3_grads(model, images, gt, valid):
    """`lfn3_train_step`'s loss (`train/trainers.py::lfn3_supervised_loss`)
    and its gradients, no optimizer step: (loss, {name: grad})."""
    from raft_optical_flow_tpu_torch.train.trainers import lfn3_supervised_loss

    model.zero_grad(set_to_none=True)
    loss = lfn3_supervised_loss(model, images, gt, valid)[0]
    loss.backward()
    return float(loss.detach()), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _lfn3_fidelity(goldens):
    """Standard and S+PseudoReg at the goldens' params against the reference
    outputs, at tests/test_lfn3_parity.py's tolerances; the bf16 policy at
    test_lfn3_bf16_policy_close's bar."""
    out = {}
    for name in ("standard", "s_pseudoreg"):
        g = np.load(os.path.join(REPO, "tests", "goldens", f"lfn3_{name}.npz"))
        images = torch.from_numpy(g["images"]).permute(0, 1, 3, 4, 2).contiguous().cuda()
        with torch.no_grad():
            res = _lfn3(name, goldens[name])(images, training=True)
        flows = res["flows"].permute(0, 1, 4, 2, 3).cpu().numpy()
        confs = res["confs"].permute(0, 1, 4, 2, 3).cpu().numpy()
        d_flow = float(np.abs(flows - g["flows"]).max())
        d_conf = float(np.abs(confs - g["confs"]).max())
        d_preds = max(float(np.abs(p.permute(0, 3, 1, 2).cpu().numpy() - g[f"{key}_{i}"]).max())
                      for key in ("flow_pred", "conf_pred")
                      for i, p in enumerate(res[key + "s"]))
        log(f"lfn3 {name} fp32 vs golden: flows max|d|={d_flow!r} (atol 3e-3) confs "
            f"max|d|={d_conf!r} (1e-3) preds max|d|={d_preds!r} (5e-4)")
        if not (d_flow <= 3e-3 and d_conf <= 1e-3 and d_preds <= 5e-4):
            raise AssertionError(f"lfn3 {name}: does not match the golden")
        out[name] = {"flows": d_flow, "confs": d_conf, "preds": d_preds}
    g = np.load(os.path.join(REPO, "tests", "goldens", "lfn3_standard.npz"))
    images = torch.from_numpy(g["images"]).permute(0, 1, 3, 4, 2).contiguous().cuda()
    res = _lfn3("standard", goldens["standard"], dtype=torch.bfloat16)(images)
    diff = np.abs(res["flows"].permute(0, 1, 4, 2, 3).cpu().numpy() - g["flows"])
    conf = np.abs(res["confs"].permute(0, 1, 4, 2, 3).cpu().numpy() - g["confs"]).mean()
    log(f"lfn3 standard bf16 vs fp32 golden: flows dtype={res['flows'].dtype} mean|d|="
        f"{float(diff.mean())!r} (< 5e-3) max|d|={float(diff.max())!r} (< 5e-2) confs "
        f"mean|d|={float(conf)!r} (< 5e-3)")
    if not (res["flows"].dtype == torch.float32 and diff.mean() < 5e-3 and diff.max() < 5e-2
            and conf < 5e-3):
        raise AssertionError("lfn3 standard bf16 is not close to the fp32 golden")
    out["standard_bf16"] = {"flows_mean": float(diff.mean()), "flows_max": float(diff.max()),
                            "confs_mean": float(conf)}
    return out


def _lfn3_card_vs_cpu(goldens):
    """All four variants at 64x96, batch 2: the card's flows against the
    port's on the CPU, same weights, same process."""
    images = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 1, (2, 2, 64, 96, 3)).astype(np.float32))
    out = {}
    for variant in LFN3_VARIANTS:
        sd = _lfn3_state_dict(variant, goldens)
        ref = _lfn3(variant, sd, "cpu")(images)["flows"]
        got = _lfn3(variant, sd)(images.cuda())["flows"].cpu()
        d = float((got - ref).abs().max())
        out[variant] = d
        log(f"lfn3 {variant} fp32 card vs CPU: flows max|d|={d!r} (tol {LFN3_FLOW_TOL}) "
            f"mean|flow|={float(ref.abs().mean())!r}")
        if not d <= LFN3_FLOW_TOL:
            raise AssertionError(f"lfn3 {variant}: the card disagrees with the CPU")
    return out


def _lfn3_serving(goldens, n_timed=5):
    """Sintel-size serving at the goldens' params: ms/call (the median of
    n_timed calls after one warm-up, each between CUDA events after a
    synchronize), pairs/s and peak memory; bf16 against fp32 mean EPE on the same frames."""
    H, W = LFN3_SERVE_HW
    runs = [(v, dt, B) for v in ("standard", "s") for dt in (torch.float32, torch.bfloat16)
            for B in (16, 1)]
    runs += [(v, torch.bfloat16, 1) for v in ("standard_pseudoreg", "s_pseudoreg")]
    frames = {}
    for B in (16, 1):
        g = torch.Generator(device="cuda").manual_seed(B)
        frames[B] = torch.rand(B, 2, H, W, 3, device="cuda", generator=g)
    res, fp32_flows = {}, {}
    for variant, dt, B in runs:
        model = _lfn3(variant, _lfn3_state_dict(variant, goldens), dtype=dt)
        result, ms, ms_all, peak = _median_ms(lambda: model(frames[B]), n_timed)
        flows = result["flows"]
        if tuple(flows.shape) != (B, 1, H, W, 2) or not torch.isfinite(flows).all():
            raise AssertionError(f"lfn3 {variant} serving: wrong shape or not finite")
        key = f"{variant}_{'fp32' if dt == torch.float32 else 'bf16'}_bs{B}"
        row = {"ms": ms, "pairs_per_s": B * 1e3 / ms, "peak_gib": peak, "ms_all": ms_all}
        if dt == torch.float32:
            fp32_flows[(variant, B)] = flows
        elif (variant, B) in fp32_flows:
            epe = torch.linalg.norm(flows - fp32_flows.pop((variant, B)), dim=-1)
            row["epe_vs_fp32_mean"] = float(epe.mean())
            row["epe_vs_fp32_max"] = float(epe.max())
        res[key] = row
        log(f"lfn3 serving {key} {H}x{W}: {ms:.3f} ms/call (median of {n_timed}: "
            f"{row['ms_all']}) {row['pairs_per_s']:.3f} pairs/s peak_mem={peak:.3f} GiB "
            f"mean|flow|={float(flows.abs().mean())!r}"
            + (f" bf16-vs-fp32 EPE mean={row['epe_vs_fp32_mean']!r} max={row['epe_vs_fp32_max']!r}"
               if "epe_vs_fp32_mean" in row else ""))
        del model, flows, result
        torch.cuda.empty_cache()
    return res


def _lfn3_draws():
    """The two batch-2 64x96 draws of phase lfn3's card-against-CPU gradient
    gate, each (images, gt, valid) from RandomState(0): "joint" draws both
    frames as one [2, 2, 64, 96, 3] array (the phase's first draw), "separate" as
    two [2, 64, 96, 3] arrays stacked after (the draw on which the gate of
    max(2e-5, 2x the card's spread) read 2.44e-5 at S+PseudoReg's
    `regularization_nets_0.conf_pred_0`)."""
    out = {}
    for name in ("joint", "separate"):
        rng = np.random.RandomState(0)
        if name == "joint":
            images = rng.uniform(0, 1, (2, 2, 64, 96, 3)).astype(np.float32)
        else:
            images = np.stack([rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
                               for _ in range(2)], axis=1)
        gt = rng.uniform(-5, 5, (2, 64, 96, 2)).astype(np.float32)
        valid = (rng.rand(2, 64, 96) > 0.2).astype(np.float32)
        out[name] = [torch.from_numpy(a) for a in (images, gt, valid)]
    return out


def _conv_kernels(fn, top=12):
    """The device kernels of fn() whose names say convolution (cuDNN's
    implicit GEMMs, Winograd, FFT and their transforms), by device time:
    [(name, ms, calls)]."""
    from torch.profiler import ProfilerActivity, profile

    keys = ("conv", "fft", "winograd", "implicit", "gemm", "wgrad", "dgrad", "region_transform",
            "xmma", "cudnn")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if any(k in e.key.lower() for k in keys)]
    return sorted(rows, key=lambda r: -r[1])[:top]


def _lfn3_gradients(goldens, n_timed=3):
    """Standard and S+PseudoReg, fp32, at the goldens' params: ms per
    forward+backward and peak memory at batch 8, 384x768; then on each of
    the two batch-2 64x96 draws (`_lfn3_draws`) each layer's gradient on
    the card, on the CPU and on the CPU in float64 (the yardstick), and the
    card's step run twice (the spread of the atomic adds in PyTorch's
    backward of the resizes and gathers). The card's loss within rel 1e-5
    of the CPU's; each layer's card-vs-CPU reading within max(2e-5, 2x the
    card's spread, 2x the CPU fp32 error against float64), and so is each
    layer's card-vs-float64 reading: a layer whose gradient fp32 cannot
    hold to 1e-5 on that draw (the CPU's own fp32 error says so) widens its
    own gate, no other. Reported beside them: the card's error against
    float64 under `cudnn.deterministic`, and the cuDNN convolution kernels
    of one batch-2 step."""
    out, failures = {}, []
    draws = _lfn3_draws()
    for variant in ("standard", "s_pseudoreg"):
        sd = goldens[variant]
        model = _lfn3(variant, sd)
        g = torch.Generator(device="cuda").manual_seed(3)
        B, (H, W) = LFN3_TRAIN_B, LFN3_TRAIN_HW
        images = torch.rand(B, 2, H, W, 3, device="cuda", generator=g)
        gt = torch.rand(B, H, W, 2, device="cuda", generator=g) * 10.0 - 5.0
        valid = torch.ones(B, H, W, device="cuda")
        _, ms, ms_all, peak = _median_ms(lambda: _lfn3_grads(model, images, gt, valid), n_timed)
        del images, gt, valid
        torch.cuda.empty_cache()
        out[variant] = {"ms": ms, "ms_all": ms_all, "peak_gib": peak}
        log(f"lfn3 grad {variant} fp32 batch={B} {H}x{W}: {ms:.3f} ms per forward+backward "
            f"(median of {n_timed}: {ms_all}) peak_mem={peak:.3f} GiB")

        cpu32 = _lfn3(variant, sd, "cpu")
        cpu64 = _lfn3(variant, sd, "cpu", dtype=torch.float64)
        for draw, small in draws.items():
            card = [t.cuda() for t in small]
            loss1, g1 = _lfn3_grads(model, *card)
            loss2, g2 = _lfn3_grads(model, *card)
            with deterministic(False):
                _, g_det = _lfn3_grads(model, *card)
            cpu_loss, cpu_grads = _lfn3_grads(cpu32, *small)
            _, f64 = _lfn3_grads(cpu64, *[t.double() for t in small])
            g1 = {k: v.cpu() for k, v in g1.items()}
            spread = layer_max_rel({k: v.cpu() for k, v in g2.items()}, g1)
            rels = layer_max_rel(g1, cpu_grads)
            card_err = layer_max_rel(g1, f64)
            cpu_err = layer_max_rel(cpu_grads, f64)
            det_err = layer_max_rel({k: v.cpu() for k, v in g_det.items()}, f64)
            loss_rel = abs(loss1 - cpu_loss) / abs(cpu_loss)
            gate = gradient_gate(spread, cpu_err)
            bad = {n: (rels[n], card_err[n], gate[n]) for n in rels
                   if not (rels[n] <= gate[n] and card_err[n] <= gate[n])}
            worst = max(rels, key=rels.get)
            worst_card = max(card_err, key=card_err.get)
            row = {"loss_rel": loss_rel, "worst_layer": worst, "worst_rel": rels[worst],
                   "worst_gate": gate[worst], "spread_max": max(spread.values()),
                   "twice_loss_equal": loss1 == loss2,
                   "card_vs_f64_worst": [worst_card, card_err[worst_card]],
                   "cpu_vs_f64_worst": max(cpu_err.values()),
                   "deterministic_vs_f64_worst": max(det_err.values()),
                   "layers": {n: {"card_vs_cpu": rels[n], "card_vs_f64": card_err[n],
                                  "cpu_vs_f64": cpu_err[n], "det_vs_f64": det_err[n],
                                  "spread": spread[n]}
                              for n in sorted(rels, key=rels.get, reverse=True)[:4]}}
            out[variant][draw] = row
            log(f"lfn3 grad {variant} draw {draw} batch 2 64x96: loss rel={loss_rel!r}; card vs "
                f"CPU worst {worst} {rels[worst]!r} (gate {gate[worst]!r}); against float64: card "
                f"worst {worst_card} "
                f"{card_err[worst_card]!r} (gate {gate[worst_card]!r}), CPU fp32 there "
                f"{cpu_err[worst_card]!r}, cudnn.deterministic there {det_err[worst_card]!r}; "
                f"card twice: loss equal={loss1 == loss2} worst spread="
                f"{max(spread.values())!r} ({max(spread, key=spread.get)}); layers "
                f"{json.dumps(row['layers'])}")
            if not loss_rel <= 1e-5 or bad:
                failures.append(f"lfn3 {variant} draw {draw}: loss rel {loss_rel!r}, layers past "
                                f"their gates: {bad}")
        kernels = _conv_kernels(lambda: _lfn3_grads(model, *[t.cuda() for t in draws["separate"]]))
        out[variant]["conv_kernels"] = kernels
        log(f"lfn3 grad {variant} batch 2 cuDNN conv kernels (name, ms, calls): {kernels!r}")
        del model, cpu32, cpu64
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def phase_lfn3(state):
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    t0 = time.perf_counter()
    goldens = {name: load_flax_npz(os.path.join(REPO, "tests", "goldens",
                                                f"lfn3_{name}_params.npz"))
               for name in ("standard", "s_pseudoreg")}
    reset_all()
    res = {"fidelity": _lfn3_fidelity(goldens), "card_vs_cpu": _lfn3_card_vs_cpu(goldens),
           "serving": _lfn3_serving(goldens), "gradients": _lfn3_gradients(goldens)}
    expect_launches(launch_counts(), {}, "lfn3 (no port kernel on its path)")
    res["seconds"] = time.perf_counter() - t0
    state["lfn3"] = res
    log(f"phase lfn3: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# SimpleFlowNet and IFNet (plain PyTorch: no port kernel lies on their paths)

FAMILY_SERVE_HW = (432, 1024)  # tools/bench_families.py's SimpleFlowNet and IFNet rows


def _golden_pair(name, keys):
    """The golden's arrays and its two frames, NHWC on the card."""
    g = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"))
    return g, [torch.from_numpy(g[k]).permute(0, 2, 3, 1).contiguous().cuda() for k in keys]


def _nchw_np(x):
    return x.permute(0, 3, 1, 2).cpu().numpy()


def _serve_rows(tag, runs, n_timed=5):
    """runs: (key, make_model, B, H, W, flow_of, stride). Each model serves
    seeded frames in [0, 1]: ms/call, pairs/s and peak memory; flow_of
    picks the served flow, which must be finite and 1/stride the frame's
    size."""
    out = {}
    for key, make, B, H, W, flow_of, stride in runs:
        g = torch.Generator(device="cuda").manual_seed(B)
        a, b = (torch.rand(B, H, W, 3, device="cuda", generator=g) for _ in range(2))
        model = make()
        res, ms, ms_all, peak = _median_ms(lambda: model(a, b), n_timed)
        flow = flow_of(res)
        if flow.shape[:3] != (B, H // stride, W // stride) or not torch.isfinite(flow).all():
            raise AssertionError(f"{tag} serving {key}: wrong shape or not finite")
        out[key] = {"ms": ms, "pairs_per_s": B * 1e3 / ms, "peak_gib": peak, "ms_all": ms_all}
        log(f"{tag} serving {key} {H}x{W}: {ms:.3f} ms/call (median of {n_timed}: {ms_all}) "
            f"{B * 1e3 / ms:.3f} pairs/s peak_mem={peak:.3f} GiB "
            f"mean|flow|={float(flow.abs().mean())!r}")
        del model, res, flow, a, b
        torch.cuda.empty_cache()
    return out


def _card_vs_cpu(tag, key, make, flows_of):
    """The card's fp32 flows against the port's on the CPU at the same
    weights, 64x96, batch 2: within 1e-4, the bar the port holds against
    JAX."""
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32))
            for _ in range(2))
    ref = flows_of(make("cpu")(a, b))
    got = flows_of(make("cuda")(a.cuda(), b.cuda()))
    d = max(float((f.cpu() - r).abs().max()) for f, r in zip(got, ref))
    log(f"{tag} {key} fp32 card vs CPU: flows max|d|={d!r} (tol 1e-4) "
        f"mean|flow|={float(ref[-1].abs().mean())!r}")
    if not d <= 1e-4:
        raise AssertionError(f"{tag} {key}: the card disagrees with the CPU")
    return d


def phase_simple_flow(state):
    from raft_optical_flow_tpu_torch.losses import simple_flow_loss
    from raft_optical_flow_tpu_torch.models import SimpleFlowConfig, SimpleFlowNet
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    t0 = time.perf_counter()
    sd = load_flax_npz(os.path.join(REPO, "tests", "goldens", "simple_flow_params.npz"))

    def make(device="cuda", dtype=torch.float32):
        model = SimpleFlowNet(SimpleFlowConfig(compute_dtype=dtype), device=device)
        model.load_state_dict(sd)
        return model

    reset_all()
    res = {"fidelity": {}}
    g, images = _golden_pair("simple_flow", ("img1", "img2"))
    for dt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        flows = make(dtype=dt)(*images)
        d = [np.abs(_nchw_np(f) - g[f"flow_{i}"]) for i, f in enumerate(flows)]
        means, maxes = [float(x.mean()) for x in d], [float(x.max()) for x in d]
        res["fidelity"][name] = {"mean": means, "max": maxes}
        log(f"simple_flow {name} vs golden, per scale (1/8, 1/4, 1/2): mean|d|={means!r} "
            f"max|d|={maxes!r} " + ("(atol 1e-3)" if name == "fp32" else "(< 4e-2, < 2e-1)"))
        ok = (max(maxes) <= 1e-3 if name == "fp32"
              else max(means) < 4e-2 and max(maxes) < 2e-1)
        if not ok or any(f.dtype != torch.float32 for f in flows):
            raise AssertionError(f"simple_flow {name}: does not match the golden")
    res["card_vs_cpu"] = _card_vs_cpu("simple_flow", "eval", make, lambda flows: flows)

    H, W = FAMILY_SERVE_HW
    # the served flow is the finest, at half the frame's size
    runs = [(f"{name}_bs{B}", functools.partial(make, dtype=dt), B, H, W, lambda f: f[-1], 2)
            for dt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")) for B in (16, 1)]
    runs += [(f"{name}_bs1_256x256", functools.partial(make, dtype=dt), 1, 256, 256,
              lambda f: f[-1], 2) for dt, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"))]
    res["serving"] = _serve_rows("simple_flow", runs)

    def supervised(model, img1, img2, gt, valid):
        return simple_flow_loss(model(img1, img2, train=True), gt, valid, img1)[0]

    res["gradients"] = _gradient_rows("simple_flow", [("supervised_bn_train", make, supervised)])
    expect_launches(launch_counts(), {}, "simple_flow (no port kernel on its path)")
    res["seconds"] = time.perf_counter() - t0
    state["simple_flow"] = res
    log(f"phase simple_flow: ok in {res['seconds']:.1f} s")


def phase_ifnet(state):
    from raft_optical_flow_tpu_torch.losses import laploss, simple_flow_loss
    from raft_optical_flow_tpu_torch.models import IFNet
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    t0 = time.perf_counter()
    sd = load_flax_npz(os.path.join(REPO, "tests", "goldens", "ifnet_params.npz"))

    def make(device="cuda", dtype=torch.float32, frw=False):
        model = IFNet(compute_dtype=dtype, feature_res_warp=frw, device=device)
        model.load_state_dict(sd)
        return model

    reset_all()
    res = {}
    g, images = _golden_pair("ifnet", ("img0", "img1"))
    flows, masks, warped = make()(*images)
    d_flow = max(float(np.abs(_nchw_np(f) - g[f"flow_{i}"]).max()) for i, f in enumerate(flows))
    d_mask = max(float(np.abs(_nchw_np(m) - g[f"mask_{i}"]).max()) for i, m in enumerate(masks))
    d_warp = max(float(np.abs(_nchw_np(w[j]) - g[f"warped{j}_{i}"]).max())
                 for i, w in enumerate(warped) for j in range(2))
    log(f"ifnet fp32 vs golden: flows max|d|={d_flow!r} (atol 2e-3) masks max|d|={d_mask!r} "
        f"(1e-3) warped max|d|={d_warp!r} (1e-3)")
    if not (d_flow <= 2e-3 and d_mask <= 1e-3 and d_warp <= 1e-3):
        raise AssertionError("ifnet fp32: does not match the golden")
    bf_flows, bf_masks, _ = make(dtype=torch.bfloat16)(*images)
    diff = np.abs(_nchw_np(bf_flows[-1]) - g["flow_2"])
    log(f"ifnet bf16 vs fp32 golden: flow_2 dtype={bf_flows[-1].dtype} mean|d|="
        f"{float(diff.mean())!r} (< 5e-3) max|d|={float(diff.max())!r} (< 5e-2)")
    if not (bf_flows[-1].dtype == bf_masks[-1].dtype == torch.float32 and diff.mean() < 5e-3
            and diff.max() < 5e-2):
        raise AssertionError("ifnet bf16 is not close to the fp32 golden")
    frw = make(frw=True)(*images)[0]
    if not torch.equal(frw[0], flows[0]):
        raise AssertionError("ifnet feature_res_warp: flow_0 differs from the reference order")
    frw_d = [(float((frw[i] - flows[i]).abs().mean()), float((frw[i] - flows[i]).abs().max()))
             for i in (1, 2)]
    log(f"ifnet feature_res_warp vs reference order: flow_0 equal; flow_1, flow_2 "
        f"(mean|d|, max|d|)={frw_d!r} (< 0.06, < 0.5)")
    if not all(m < 0.06 and x < 0.5 for m, x in frw_d):
        raise AssertionError("ifnet feature_res_warp is not close to the reference order")
    res["fidelity"] = {"fp32": {"flows": d_flow, "masks": d_mask, "warped": d_warp},
                       "bf16_flow_2": {"mean": float(diff.mean()), "max": float(diff.max())},
                       "frw": frw_d}
    res["card_vs_cpu"] = {
        key: _card_vs_cpu("ifnet", key, functools.partial(make, frw=frw_on), lambda out: out[0])
        for key, frw_on in (("reference_order", False), ("feature_res_warp", True))}

    H, W = FAMILY_SERVE_HW
    runs = [(f"{name}_bs{B}", functools.partial(make, dtype=dt, frw=frw_on), B, H, W,
             lambda out: out[0][-1], 1)
            for dt, frw_on, name in ((torch.float32, False, "fp32"), (torch.bfloat16, False, "bf16"),
                                     (torch.bfloat16, True, "bf16_frw"))
            for B in (16, 1)]
    res["serving"] = _serve_rows("ifnet", runs)

    def supervised(model, img1, img2, gt, valid):
        flows, _, _ = model(img1, img2, train=True)
        return simple_flow_loss([f[..., 2:4] for f in flows], gt, valid, img1)[0]

    def unsupervised(model, img1, img2, gt, valid):
        _, _, warped = model(img1, img2, train=True)
        return laploss(warped, img1, img2)[0]

    res["gradients"] = _gradient_rows("ifnet", [("supervised", make, supervised),
                                                ("unsupervised_laploss", make, unsupervised)])
    expect_launches(launch_counts(), {}, "ifnet (no port kernel on its path)")
    res["seconds"] = time.perf_counter() - t0
    state["ifnet"] = res
    log(f"phase ifnet: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# The family trainers and RAFT-small's UFlow step (`train/trainers.py`)

FLOW_KINDS = ("lfn3", "lfn3_unsup", "simple_flow", "simple_flow_unsup", "ifnet", "ifnet_unsup",
              "raft_uflow_unsup")
# tools/unsup_bootstrap_tpu.sh's round-5 recipe: crop 256x384, batch 4; the
# occlusion masks on from step 0
UFLOW_HW, UFLOW_B = (256, 384), 4
UFLOW_KW = dict(iters=4, selfsup_crop=8, sequence_gamma=0.8, occlusion_warmup_steps=0)
UFLOW_CHECK_KW = dict(UFLOW_KW, iters=2)  # the batch-2 check's depth (tests' shape)


def _uflow_launches(iters, hw, crop=8):
    """K1 and K3 per UFlow step: 4 model runs (fw and bw on the frames, and
    on the student's crop) x iters x RAFT-small's non-empty pyramid levels
    (4, the coarsest halved with the floor; an empty level launches
    nothing), each lookup a K1 launch (training does not fuse the coarse
    levels) whose backward is a K3 launch."""
    def levels(H, W):
        h, w, n = H // 8, W // 8, 0
        for _ in range(4):
            n += h > 0 and w > 0
            h, w = h // 2, w // 2
        return n

    H, W = hw
    n = 2 * iters * (levels(H, W) + levels(H - 2 * crop, W - 2 * crop))
    return {"corr_lookup_level": n, "corr_lookup_level_bwd": n}


FLOW_WEIGHTS = {"lfn3": "tests/goldens/lfn3_standard_params.npz",
                "simple_flow": "tests/goldens/simple_flow_params.npz",
                "ifnet": "tests/goldens/ifnet_params.npz",
                "raft_uflow": "checkpoints/raft_small.npz"}


def _flow_trainer(kind, device, step_kwargs=None, model_config=None):
    """FlowTrainer of `kind` at the goldens' params (RAFT-small at
    checkpoints/raft_small.npz): at the port's seeded initialization
    LiteFlowNet3's fp32 gradients lie up to 0.85 (a layer's max|d| over its
    max) off float64 on the CPU itself, no yardstick for the card."""
    from raft_optical_flow_tpu_torch.train.trainers import FlowTrainer
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint

    restore = load_flax_checkpoint(os.path.join(REPO, FLOW_WEIGHTS[kind.replace("_unsup", "")]))
    return FlowTrainer(kind, (64, 96), model_config=model_config, restore_variables=restore,
                       device=device, step_kwargs=step_kwargs)


def flow_step(trainer, batch, step=0):
    """(metrics, {name: grad on the CPU}) of one step (`utils/grad_check.py`)."""
    from raft_optical_flow_tpu_torch.utils import grad_check

    return grad_check.flow_step(trainer, batch, step)


def _flow_batch(B, H, W, seed, device="cuda"):
    """cli/train_flow.py's synthetic batch (uniform 0-255 frames, flow in
    +-5, valid ones) as tensors on `device`."""
    from raft_optical_flow_tpu_torch.cli.train_flow import _synthetic_batches

    return {k: torch.from_numpy(v).to(device) for k, v in
            next(_synthetic_batches(B, (H, W), seed)).items()}


def _flow_step_rows(n_timed=3):
    """Each kind at full width (families batch 8, 384x768; UFlow batch 4,
    256x384, 4 iterations): one FlowTrainer.train_step to warm up, then
    n_timed timed (CUDA events after a synchronize), the median ms/step and
    peak memory; every metric finite, grad_norm > 0, every step's launches
    counted from 0 (UFlow: `_uflow_launches` of K1 and K3, 64 each; the
    families none)."""
    out = {}
    for kind in FLOW_KINDS:
        uflow = kind == "raft_uflow_unsup"
        B, (H, W) = (UFLOW_B, UFLOW_HW) if uflow else (FAMILY_TRAIN_B, FAMILY_TRAIN_HW)
        trainer = _flow_trainer(kind, "cuda", UFLOW_KW if uflow else None)
        batch = _flow_batch(B, H, W, seed=3)
        counts = []

        def step():
            reset_all()
            m = trainer.train_step(batch)
            counts.append(launch_counts())
            return m

        metrics, ms, ms_all, peak = _median_ms(step, n_timed)
        metrics = {k: float(v) for k, v in metrics.items()}
        for c in counts:
            expect_launches(c, _uflow_launches(4, UFLOW_HW) if uflow else {},
                            f"flow_train {kind} step")
        if not all(math.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
            raise AssertionError(f"flow_train {kind}: metrics {metrics}")
        out[kind] = {"ms": ms, "ms_all": ms_all, "peak_gib": peak, "batch": B, "hw": [H, W],
                     "launches": counts[-1], "metrics": metrics}
        log(f"flow_train {kind} fp32 batch={B} {H}x{W}: {ms:.3f} ms/step (median of {n_timed}: "
            f"{ms_all}) peak_mem={peak:.3f} GiB launches/step "
            f"{ {k: v for k, v in counts[-1].items() if v} } metrics {metrics}")
        del trainer, batch
        torch.cuda.empty_cache()
    return out


def _uflow_frames(B, hw):
    """B real frame pairs at hw: the RAFT-small golden's 192x320 pair
    resized bilinearly, and its flips (left-right, up-down, both); 0-255,
    with a seeded flow for the monitoring EPE."""
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    pair = torch.from_numpy(np.stack([g["image1"], g["image2"]])).float().permute(0, 3, 1, 2)
    pair = F.interpolate(pair, size=hw, mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    views = [pair, pair.flip(2), pair.flip(1), pair.flip(1).flip(2)][:B]
    flow = np.random.RandomState(7).uniform(-3, 3, (B, *hw, 2)).astype(np.float32)
    return {"image1": torch.stack([v[0] for v in views]).numpy(),
            "image2": torch.stack([v[1] for v in views]).numpy(), "flow": flow}


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward multiplies the cotangent by c."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


BWD_SCALE = 1.0 + 2.0**-10  # not a power of 2: every product of the backward rounds anew


def _backward_scaled(model):
    """A forward hook on `model` whose outputs pass their cotangent on times
    BWD_SCALE: the forward is unchanged bit for bit, and the model's whole
    backward runs on scaled values, so gradients / BWD_SCALE differ from the
    unscaled ones by the backward's own rounding."""
    return model.register_forward_hook(lambda m, inputs, out: _ScaleGrad.apply(out, BWD_SCALE))


def _uflow_vs_plain():
    """RAFT-small's UFlow step at full width (batch 4, 256x384, 4 iterations,
    the 240x368 student crops; real frames, `_uflow_frames`; train state at
    step 200, the self-supervision live) through K1 and K3, against the
    same step through the plain lookup (`corr_impl='plain'`), from the same
    weights on the same batch, under cuDNN's and PyTorch's deterministic
    algorithms, as phase train holds RAFT-small's supervised step: the loss
    bit for bit (K1 repeats its plain version's operations), each layer's
    gradient within max(2e-5, 2x the spread of the kernel step run twice,
    2x the floor). K1 leaves the forward bit for bit, so the two steps
    differ only in K3's sums, which run in another order than the plain
    backward's, and this step's fnet gradient sums K3's output over 4 runs
    x 4 iterations x 4 levels through instance norms. The floor is that
    kind of difference and no other: the plain step against itself with
    the cotangent into the model scaled by 1 + 2^-10 (`_backward_scaled`),
    which rounds every product of its backward anew and leaves its forward
    as it was (a change of the weights would move the forward across the
    occlusion masks' thresholds as well)."""
    from raft_optical_flow_tpu_torch.models import RAFTConfig

    batch = _uflow_frames(UFLOW_B, UFLOW_HW)
    runs = []
    with deterministic(algorithms=True):
        for impl, scaled in (("cuda", False), ("cuda", False), ("plain", False), ("plain", True)):
            trainer = _flow_trainer("raft_uflow_unsup", "cuda", UFLOW_KW,
                                    RAFTConfig(small=True, corr_impl=impl))
            hook = _backward_scaled(trainer.model) if scaled else None
            reset_all()
            runs.append(flow_step(trainer, batch, step=200))
            if hook is not None:
                hook.remove()
                runs[-1] = (runs[-1][0], {k: g / BWD_SCALE for k, g in runs[-1][1].items()})
            expect_launches(launch_counts(), _uflow_launches(4, UFLOW_HW) if impl == "cuda" else {},
                            f"flow_train raft_uflow_unsup full-width step, corr_impl={impl}")
            del trainer
    (m1, g1), (m2, g2), (mp, gp), (ms, g_scaled) = runs
    spread = layer_max_rel(g2, g1)
    floor = layer_max_rel(g_scaled, gp)
    rels = layer_max_rel(g1, gp)
    gate = gradient_gate(spread, floor)
    bad = {n: (r, gate[n]) for n, r in rels.items() if not r <= gate[n]}
    worst = max(rels, key=rels.get)
    out = {"loss": m1["loss"], "loss_plain": mp["loss"], "worst_layer": worst,
           "worst_rel": rels[worst], "worst_gate": gate[worst], "spread_max": max(spread.values()),
           "floor_max": max(floor.values())}
    log(f"flow_train raft_uflow_unsup fp32 batch={UFLOW_B} {UFLOW_HW[0]}x{UFLOW_HW[1]} K1/K3 vs "
        f"plain lookup (deterministic algorithms on): loss {m1['loss']!r} vs {mp['loss']!r}; "
        f"worst layer {worst} max_rel={rels[worst]!r} (gate {gate[worst]!r}, floor there "
        f"{floor[worst]!r}); kernel step twice: worst spread={max(spread.values())!r}; plain "
        f"floor worst={max(floor.values())!r} ({max(floor, key=floor.get)})")
    if m1["loss"] != mp["loss"] or ms["loss"] != mp["loss"] or bad:
        raise AssertionError(f"flow_train UFlow K1/K3 vs plain: loss {m1['loss']!r} vs "
                             f"{mp['loss']!r}, layers past their gates: {bad}")
    torch.cuda.empty_cache()
    return out


def _flow_card_vs_cpu():
    """Each kind at batch 2 (families 64x96 synthetic; UFlow 48x64 crops of
    the golden frames, `grad_check.uflow_check_batch`, 2 iterations, train
    state at step 200 so the self-supervision weight is live): the card's
    step against the port's on the CPU from the same weights, loss rel <=
    1e-5 and each layer's gradient within `gradient_gate`: the families
    max(2e-5, 2x the spread of the card's step run twice). RAFT-small's
    UFlow gradients are ill-conditioned: its gate also takes 2x the floor,
    the CPU step against itself with every weight changed by one ulp, and
    the card's error against the port in float64 on the CPU must lie within
    it too. Reported beside it, the reading that says which side carries
    the error: the CPU's fp32 error against float64 and the card's, also
    under cudnn.deterministic."""
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.utils.grad_check import nudge_weights, uflow_check_batch

    out = {}
    f64_cfg = RAFTConfig(small=True, corr_impl="plain", compute_dtype=torch.float64)
    for kind in FLOW_KINDS:
        uflow = kind == "raft_uflow_unsup"
        kw, step = (UFLOW_CHECK_KW, 200) if uflow else (None, 0)
        batch = (uflow_check_batch(REPO) if uflow
                 else {k: v.numpy() for k, v in _flow_batch(2, 64, 96, seed=5, device="cpu").items()})
        runs = {}
        for name in ("card", "card2", "cpu") + (("card_det", "cpu_nudged", "f64") if uflow else ()):
            device = "cuda" if name.startswith("card") else "cpu"
            trainer = _flow_trainer(kind, device, kw, f64_cfg if name == "f64" else None)
            if name == "cpu_nudged":
                nudge_weights(trainer.model)
            dtype = np.float64 if name == "f64" else np.float32
            reset_all()
            with deterministic(False) if name == "card_det" else contextlib.nullcontext():
                runs[name] = flow_step(trainer, {k: v.astype(dtype) for k, v in batch.items()}, step)
            if device == "cuda":
                expect_launches(launch_counts(), _uflow_launches(2, (48, 64)) if uflow else {},
                                f"flow_train {kind} batch-2 step")
        (m1, g1), (m2, g2), (cpu_m, cpu_grads) = runs["card"], runs["card2"], runs["cpu"]
        spread = layer_max_rel(g2, g1)
        rels = layer_max_rel(g1, cpu_grads)
        row, card_err, floor = {}, rels, None
        if uflow:
            f64 = runs["f64"][1]
            floor = layer_max_rel(runs["cpu_nudged"][1], cpu_grads)
            card_err, cpu_err = layer_max_rel(g1, f64), layer_max_rel(cpu_grads, f64)
            det_err = layer_max_rel(runs["card_det"][1], f64)
            worst_card = max(card_err, key=card_err.get)
            row = {"floor_max": max(floor.values()),
                   "card_vs_f64_worst": [worst_card, card_err[worst_card]],
                   "cpu_vs_f64_worst": max(cpu_err.values()),
                   "deterministic_vs_f64_worst": max(det_err.values())}
        gate = gradient_gate(spread, floor)
        loss_rel = abs(m1["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
        bad = {n: (rels[n], card_err[n], gate[n]) for n in rels
               if not (rels[n] <= gate[n] and card_err[n] <= gate[n])}
        worst = max(rels, key=rels.get)
        out[kind] = dict(row, loss_rel=loss_rel, worst_layer=worst, worst_rel=rels[worst],
                         worst_gate=gate[worst], spread_max=max(spread.values()),
                         twice_loss_equal=m1["loss"] == m2["loss"])
        log(f"flow_train {kind} batch 2 card vs CPU: loss rel={loss_rel!r} worst layer {worst} "
            f"max_rel={rels[worst]!r} (gate {gate[worst]!r}); card twice: loss equal="
            f"{m1['loss'] == m2['loss']} worst spread={max(spread.values())!r} "
            f"({max(spread, key=spread.get)})"
            + (f"; CPU floor worst={row['floor_max']!r} ({max(floor, key=floor.get)}); against "
               f"float64 on the CPU: card worst {row['card_vs_f64_worst']!r} (gate "
               f"{gate[worst_card]!r}), CPU fp32 there {cpu_err[worst_card]!r}, "
               f"cudnn.deterministic there {det_err[worst_card]!r}; worst: CPU fp32 "
               f"{row['cpu_vs_f64_worst']!r}, cudnn.deterministic "
               f"{row['deterministic_vs_f64_worst']!r}" if uflow else ""))
        if not loss_rel <= 1e-5 or bad:
            raise AssertionError(f"flow_train {kind}: loss rel {loss_rel!r}, layers past their "
                                 f"gates: {bad}")
    return out


def _range_map_checks():
    """UFlow's range map (the splat of every wang mask) at the full-width
    UFlow shape: twice on the card bit for bit, and within 1e-5 of the CPU,
    with no downsampling (the wang estimator's) and at 4x with the bias
    correction and the resize (wang4's); the same for UnFlow's splat."""
    from raft_optical_flow_tpu_torch.losses import uflow
    from raft_optical_flow_tpu_torch.ops.unflow_ops import forward_warp_op

    g = torch.Generator(device="cuda").manual_seed(11)
    H, W = UFLOW_HW
    flow = torch.rand(UFLOW_B, H, W, 2, device="cuda", generator=g) * 16.0 - 8.0
    out = {}
    for name, fn in (("range_map", lambda f: uflow.compute_range_map(f, 1, False, False)),
                     ("range_map_4", lambda f: uflow.compute_range_map(f, 4, True, True)),
                     ("forward_warp_op", forward_warp_op)):
        a, b = fn(flow), fn(flow)
        d = float((a.cpu() - fn(flow.cpu())).abs().max())
        out[name] = {"twice_equal": bool(torch.equal(a, b)), "cpu_max_abs": d,
                     "mean": float(a.mean())}
        log(f"flow_train {name} batch={UFLOW_B} {H}x{W}: card twice bit for bit="
            f"{out[name]['twice_equal']} card vs CPU max|d|={d!r} (1e-5) mean={out[name]['mean']!r}")
        if not (out[name]["twice_equal"] and d <= 1e-5):
            raise AssertionError(f"flow_train {name}: not deterministic or off the CPU")
    return out


def _train_flow_cli():
    """`train_flow.main` for two synthetic steps on the card; the weights
    file it writes reloads into the model it trained."""
    import shutil

    from raft_optical_flow_tpu_torch.cli import train_flow
    from raft_optical_flow_tpu_torch.utils.weights import flax_to_state_dict, load_flax_checkpoint

    ckpt = os.path.join(REPO, "raft_optical_flow_tpu_torch", "_build", "flow_train_cli")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        trainer = train_flow.main(["--model", "simple_flow", "--unsupervised", "--synthetic",
                                   "--num_steps", "2", "--batch_size", "2", "--image_size", "64",
                                   "96", "--checkpoint_dir", ckpt, "--device", "cuda:0"])
        weights = flax_to_state_dict(load_flax_checkpoint(os.path.join(ckpt, "simple_flow_unsup.npz")))
        sd = trainer.model.state_dict()
        ok = (trainer.state.step == 2 and weights.keys() == sd.keys()
              and all(torch.equal(weights[k], v.cpu()) for k, v in sd.items()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"flow_train train_flow CLI (simple_flow --unsupervised, 2 synthetic steps on "
        f"{trainer.device}): weights file reloads equal={ok}")
    if not ok:
        raise AssertionError("train_flow CLI: the weights file does not reload")
    return ok


def phase_flow_train(state):
    t0 = time.perf_counter()
    reset_all()
    res = {"steps": _flow_step_rows(), "uflow_vs_plain": _uflow_vs_plain(),
           "card_vs_cpu": _flow_card_vs_cpu(), "splats": _range_map_checks(),
           "cli": _train_flow_cli()}
    res["seconds"] = time.perf_counter() - t0
    state["flow_train"] = res
    log(f"phase flow_train: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# the data layer and the inference drivers (plain host code around K1-K3)

CHAIRS_HW = (384, 512)
SINTEL_HW = (436, 1024)
KITTI_HWS = ((375, 1242), (370, 1224), (376, 1241))  # three of KITTI 2015's frame sizes
KITTI_BUCKET = (384, 1280)  # all three, padded to multiples of 64
SINTEL_SCENES = ("ambush_2", "market_2")
CHAIRS_CROP = (368, 496)
DATA_EVAL_DIR = os.path.join(REPO, "raft_optical_flow_tpu_torch", "_build", "data_eval")


@contextlib.contextmanager
def _patched(owner, name, make):
    """owner.name replaced by make(original) for the block, then restored."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _base_frames():
    """The RAFT-small golden's two real 192x320 frames, uint8."""
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    return [np.clip(np.rint(g[k]), 0, 255).astype(np.uint8) for k in ("image1", "image2")]


def _warped_sequence(base, hw, n, seed, max_flow=6.0):
    """n frames at hw ending in `base` resized to hw, each the next one warped
    by a smooth seeded flow g_i (`data/synthetic.py`'s construction: frame i
    samples frame i+1 at grid + g_i, so the flow from frame i to frame i+1 is
    g_i). Returns (frames uint8 [hw, 3], flows float32 [hw, 2])."""
    from raft_optical_flow_tpu_torch.data.cv import resize_linear
    from raft_optical_flow_tpu_torch.data.synthetic import _bilinear_gather, _smooth_flow

    r = np.random.RandomState(seed)
    H, W = hw
    frame = resize_linear(base, W / base.shape[1], H / base.shape[0]).astype(np.float32)
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames, flows = [frame], []
    for _ in range(n - 1):
        g = _smooth_flow(r, H, W, max_flow)
        frames.insert(0, _bilinear_gather(frames[0], np.stack([gx + g[..., 0], gy + g[..., 1]], -1)))
        flows.insert(0, g)
    return [np.clip(np.rint(f), 0, 255).astype(np.uint8) for f in frames], flows


def _write_trees(root, datasets=("chairs", "sintel", "kitti")):
    """FlyingChairs (12 pairs at 384x512, .ppm + .flo, chairs_split.txt: 10
    training, 2 validation), Sintel (training/{clean,final}/<scene>/
    frame_000{1..3}.png and flow/<scene>/*.flo at 436x1024; final = clean
    plus seeded noise) and KITTI (training/image_2/*_1{0,1}.png and 16-bit
    flow_occ/*_10.png at three real sizes, about half the pixels valid),
    those of them named in `datasets`, written by the port's writers and
    read back bit for bit. Returns ({name: root}, files, seconds to write)."""
    from raft_optical_flow_tpu_torch.data import frame_utils as fu

    t0 = time.perf_counter()
    written = {}  # path -> (reader, the array a reader must return)

    def put(path, arr, writer, reader, expect=None):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        writer(path, arr)
        written[path] = (reader, arr if expect is None else expect)

    base = _base_frames()
    chairs = os.path.join(root, "FlyingChairs_release", "data")
    for i in range(12 if "chairs" in datasets else 0):
        (f1, f2), (g,) = _warped_sequence(base[i % 2], CHAIRS_HW, 2, seed=i)
        put(os.path.join(chairs, f"{i:05d}_img1.ppm"), f1, fu.write_ppm, fu.read_ppm)
        put(os.path.join(chairs, f"{i:05d}_img2.ppm"), f2, fu.write_ppm, fu.read_ppm)
        put(os.path.join(chairs, f"{i:05d}_flow.flo"), g, fu.write_flow, fu.read_flow)
    if "chairs" in datasets:
        np.savetxt(os.path.join(root, "FlyingChairs_release", "chairs_split.txt"),
                   np.array([1] * 10 + [2] * 2), fmt="%d")
    sintel = os.path.join(root, "Sintel")
    for s, scene in enumerate(SINTEL_SCENES if "sintel" in datasets else ()):
        frames, flows = _warped_sequence(base[s], SINTEL_HW, 3, seed=100 + s)
        noise = np.random.RandomState(110 + s)
        for i, f in enumerate(frames):
            final = np.clip(f.astype(np.int32) + noise.randint(-4, 5, f.shape), 0, 255)
            for dstype, img in (("clean", f), ("final", final.astype(np.uint8))):
                put(os.path.join(sintel, "training", dstype, scene, f"frame_{i + 1:04d}.png"), img,
                    fu.write_png, fu.read_png)
        for i, g in enumerate(flows):
            put(os.path.join(sintel, "training", "flow", scene, f"frame_{i + 1:04d}.flo"), g,
                fu.write_flow, fu.read_flow)
    kitti = os.path.join(root, "KITTI")
    for i, hw in enumerate(KITTI_HWS if "kitti" in datasets else ()):
        (f1, f2), (g,) = _warped_sequence(base[i % 2], hw, 2, seed=200 + i)
        put(os.path.join(kitti, "training", "image_2", f"{i:06d}_10.png"), f1, fu.write_png, fu.read_png)
        put(os.path.join(kitti, "training", "image_2", f"{i:06d}_11.png"), f2, fu.write_png, fu.read_png)
        valid = np.random.RandomState(210 + i).uniform(0, 1, hw) > 0.5
        raster = np.concatenate([64.0 * g + 2 ** 15, valid[..., None]], -1).astype(np.uint16)
        put(os.path.join(kitti, "training", "flow_occ", f"{i:06d}_10.png"), g,
            lambda p, a, v=valid: fu.write_flow_kitti(p, a, v), fu.read_png, raster)
    write_s = time.perf_counter() - t0
    for path, (reader, expect) in written.items():
        got = reader(path)
        if got.dtype != expect.dtype or not np.array_equal(got, expect):
            raise AssertionError(f"data_eval: {path} does not read back as written")
    return {"chairs": chairs, "sintel": sintel, "kitti": kitti}, len(written), write_s


def _loader_rate(chairs_root, batches=4):
    """Pairs/s of FlowDataLoader over the chairs stage (batch 10, 4 workers,
    368x496 crops), from a cold start to the end of `batches` batches."""
    from raft_optical_flow_tpu_torch.data.datasets import fetch_dataset
    from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader

    loader = FlowDataLoader(fetch_dataset("chairs", CHAIRS_CROP, roots={"chairs": chairs_root}),
                            batch_size=10, num_workers=4, seed=1234)
    it = loader.epochs()
    t0 = time.perf_counter()
    for _ in range(batches):
        b = next(it)
    secs = time.perf_counter() - t0
    it.close()
    if b["image1"].shape != (10, *CHAIRS_CROP, 3) or not np.isfinite(b["flow"]).all():
        raise AssertionError("data_eval: the chairs loader's batch is malformed")
    return 10 * batches / secs


def _chairs_stage(chairs_root, ckdir):
    """`cli/train_raft.main --stage chairs --data_root <tree>` for 3 steps
    (RAFT-standard fp32, BatchNorm training, seeded weights, batch 10,
    368x496), `--validation chairs` firing after step 3: each step timed on
    its own (host clock around a synchronize) with its launches, and the
    validation pass's launches."""
    from raft_optical_flow_tpu_torch.cli import evaluate as cli_eval
    from raft_optical_flow_tpu_torch.cli import train_raft
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer

    steps, vals = [], []

    def timed_step(step):
        def run(self, batch):
            torch.cuda.synchronize()
            reset_all()
            t0 = time.perf_counter()
            m = step(self, batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "start": t0,
                          "launches": launch_counts(), "loss": float(m["loss"])})
            return m
        return run

    def counted_validation(make):
        def build(*a, **k):
            val_fn = make(*a, **k)

            def run(model):
                torch.cuda.synchronize()
                reset_all()
                res = val_fn(model)
                torch.cuda.synchronize()
                vals.append({"results": res, "launches": launch_counts()})
                return res
            return run
        return build

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched(RAFTTrainer, "train_step", timed_step), \
            _patched(cli_eval, "make_validation_fn", counted_validation):
        trainer = train_raft.main([
            "--name", "chairs_smoke", "--stage", "chairs", "--data_root", chairs_root,
            "--image_size", *map(str, CHAIRS_CROP), "--batch_size", "10", "--num_steps", "3",
            "--validation", "chairs", "--val_freq", "3", "--checkpoint_dir", ckdir,
            "--device", "cuda:0"])
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    iters = trainer.stage.iters
    for s in steps:
        expect_launches(s["launches"], {"corr_lookup_level": 4 * iters,
                                        "corr_lookup_level_bwd": 4 * iters}, "chairs-stage step")
    if len(steps) != 3 or len(vals) != 1 or not all(np.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"chairs stage: {len(steps)} steps, {len(vals)} validations, "
                             f"losses {[s['loss'] for s in steps]}")
    n_val = 2
    expect_launches(vals[0]["launches"], {"corr_lookup_level": n_val * iters,
                                          "corr_lookup_coarse_fused": n_val * iters},
                    "chairs validation")
    ms = [s["ms"] for s in steps]
    gaps = [(b["start"] - a["start"]) * 1e3 for a, b in zip(steps, steps[1:])]
    return {"ms": ms, "ms_steps_2_3": ms[1:], "ms_between_starts": gaps, "peak_gib": peak,
            "losses": [s["loss"] for s in steps], "launches_per_step": steps[-1]["launches"],
            "validation": vals[0]["results"], "validation_launches": vals[0]["launches"],
            "seconds": secs, "pairs_per_s": 10e3 / float(np.mean(ms[1:])), "iters": iters}


def _recording(fwd, rec):
    """fwd with each call timed (host clock around a synchronize), its
    launches counted from 0, and its inputs' shape and outputs kept."""
    def run(image1, image2, flow_init=None):
        torch.cuda.synchronize()
        reset_all()
        t0 = time.perf_counter()
        low, up = fwd(image1, image2, flow_init)
        torch.cuda.synchronize()
        rec.append({"ms": (time.perf_counter() - t0) * 1e3, "launches": launch_counts(),
                    "shape": tuple(image1.shape), "warm": flow_init is not None,
                    "low": low.clone(), "up": up.clone()})
        return low, up

    run.device = fwd.device
    return run


def _validators(roots, sd):
    """Each validator at full size on the card, RAFT-small fp32 from the
    checkpoint, through `cli/evaluate.main` (K1 and K2), then again through
    the plain lookup (`corr_impl='plain'`) from the same weights, both under
    cudnn.deterministic: flows of every pair bit for bit, metrics equal,
    K1 and K2 `iters` launches per pair."""
    from raft_optical_flow_tpu_torch.cli import evaluate as cli_eval
    from raft_optical_flow_tpu_torch.data import datasets as D
    from raft_optical_flow_tpu_torch.eval import evaluate as E
    from raft_optical_flow_tpu_torch.models import RAFTConfig

    ckpt = os.path.join(REPO, "checkpoints", "raft_small.npz")
    samples = cli_eval._eval_samples
    out = {}
    for name, iters in (("sintel", 32), ("kitti", 24), ("chairs", 24)):
        rec, rec_p = [], []
        with deterministic(algorithms=False):
            with _patched(E, "make_raft_forward",
                          lambda make: lambda *a, **k: _recording(make(*a, **k), rec)):
                res = cli_eval.main(["--model", ckpt, "--small", "--iters", str(iters),
                                     "--dataset", name, f"--{name}_root", roots[name]])
            fwd = _recording(E.make_raft_forward(RAFTConfig(small=True, corr_impl="plain"), sd,
                                                 iters), rec_p)
            if name == "sintel":
                res_p = {}
                for dstype in ("clean", "final"):
                    ds = D.MpiSintelVal(None, root=roots[name], dstype=dstype)
                    res_p.update(E.validate_sintel(fwd, samples(ds), dstype))
            elif name == "kitti":
                res_p = E.validate_kitti(fwd, samples(D.KITTI(None, root=roots[name])))
            else:
                res_p = E.validate_chairs(
                    fwd, samples(D.FlyingChairs(None, "validation", root=roots[name])))
        for r in rec:
            expect_launches(r["launches"], {"corr_lookup_level": iters,
                                            "corr_lookup_coarse_fused": iters}, f"{name} validator")
        for r in rec_p:
            expect_launches(r["launches"], {}, f"{name} validator, plain lookup")
        equal = len(rec) == len(rec_p) and all(
            torch.equal(a["up"], b["up"]) and torch.equal(a["low"], b["low"])
            for a, b in zip(rec, rec_p))
        shapes = sorted({r["shape"] for r in rec})
        ms = [r["ms"] for r in rec]
        out[name] = {"results": res, "results_plain": res_p, "pairs": len(rec), "iters": iters,
                     "flows_equal": equal, "shapes": shapes, "ms_per_pair": float(np.median(ms[1:])),
                     "ms_readings": ms, "launches_per_pair": rec[0]["launches"]}
        log(f"data_eval validate_{name}: {len(rec)} pairs at {shapes}, {iters} iterations, "
            f"metrics {res}; plain lookup flows equal={equal}, metrics equal={res == res_p}; "
            f"{out[name]['ms_per_pair']:.3f} ms/pair (median after the first; "
            f"{[round(t, 3) for t in ms]}), launches per pair {rec[0]['launches']}")
        if not (equal and res == res_p and all(np.isfinite(v) for v in res.values())):
            raise AssertionError(f"data_eval: validate_{name} through K1/K2 is not the plain "
                                 "lookup's, or not finite")
        if name == "kitti" and shapes != [(1, *KITTI_BUCKET, 3)]:
            raise AssertionError(f"data_eval: KITTI frames fall into {shapes}, not one "
                                 f"{KITTI_BUCKET} bucket")
    return out


def _submissions(roots, sd, outdir):
    """create_sintel_submission (warm start: flow_init through the model on
    the card) and create_kitti_submission, every file read back: shapes of
    the frames, values those written (.flo exactly, KITTI within 1/64 px)."""
    from raft_optical_flow_tpu_torch.data import datasets as D
    from raft_optical_flow_tpu_torch.data import frame_utils as fu
    from raft_optical_flow_tpu_torch.eval import evaluate as E
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.ops.padding import InputPadder

    rec = []
    fwd = _recording(E.make_raft_forward(RAFTConfig(small=True), sd, 32), rec)
    sintel = D.MpiSintel(None, split="training", root=roots["sintel"], dstype="clean", repeat=1)
    by_seq = {}
    for i in range(len(sintel)):
        img1, img2, *_ = sintel.__getitem__(i)
        scene, fid = sintel.extra_info[i]
        by_seq.setdefault(scene, []).append((img1, img2, fid))
    E.create_sintel_submission(fwd, list(by_seq.items()), os.path.join(outdir, "sintel"),
                               warm_start=True)
    checked, k = 0, 0
    for scene, frames in by_seq.items():
        for j, (img1, _, fid) in enumerate(frames):
            r = rec[k]
            k += 1
            flow = fu.read_flow(os.path.join(outdir, "sintel", scene, f"frame{fid + 1:04d}.flo"))
            want = InputPadder((1,) + img1.shape).unpad(r["up"])[0].cpu().numpy()
            if r["warm"] != (j > 0) or flow.shape != img1.shape[:2] + (2,) \
                    or not np.array_equal(flow, want):
                raise AssertionError(f"data_eval: Sintel submission {scene} {fid} is not the flow")
            checked += 1
    kitti = D.KITTI(None, split="training", root=roots["kitti"])
    frames = []
    for i in range(len(kitti)):
        img1, img2, *_ = kitti.__getitem__(i)
        frames.append((img1, img2, kitti.extra_info[i][0]))
    n_sintel = len(rec)
    E.create_kitti_submission(fwd, frames, os.path.join(outdir, "kitti"))
    worst = 0.0
    for (img1, _, name), r in zip(frames, rec[n_sintel:]):
        flow, valid = fu.read_flow_kitti(os.path.join(outdir, "kitti", name))
        want = InputPadder((1,) + img1.shape, mode="kitti").unpad(r["up"])[0].cpu().numpy()
        err = float(np.abs(flow - want).max())
        worst = max(worst, err)
        if flow.shape != img1.shape[:2] + (2,) or err >= 1 / 64 or valid.min() != 1.0:
            raise AssertionError(f"data_eval: KITTI submission {name}: max|d| {err}")
        checked += 1
    for r in rec:
        expect_launches(r["launches"], {"corr_lookup_level": 32, "corr_lookup_coarse_fused": 32},
                        "submission")
    log(f"data_eval submissions: Sintel {n_sintel} .flo (warm start on {sum(r['warm'] for r in rec)}"
        f" frames) and KITTI {len(frames)} PNGs at "
        f"{sorted({r['shape'] for r in rec[n_sintel:]})} read back; KITTI max|d| {worst!r} "
        f"(< 1/64)")
    return {"files": checked, "kitti_max_abs_err": worst,
            "warm_frames": sum(r["warm"] for r in rec)}


def _demos(sintel_root, outdir):
    """cli/demo.main on the Sintel clean scene: RAFT-small (20 iterations,
    K1 and K2 20 launches a pair) and LiteFlowNet3 at the goldens' params
    (no port kernel); each PNG read back as (2 x 436, 1024, 3) uint8."""
    from raft_optical_flow_tpu_torch.cli import demo
    from raft_optical_flow_tpu_torch.data import frame_utils as fu

    scene = os.path.join(sintel_root, "training", "clean", SINTEL_SCENES[0])
    out = {}
    for arch, model, extra, per_pair in (
        ("raft", os.path.join(REPO, "checkpoints", "raft_small.npz"), ["--small"],
         {"corr_lookup_level": 20, "corr_lookup_coarse_fused": 20}),
        ("liteflownet3", os.path.join(REPO, "tests", "goldens", "lfn3_standard_params.npz"), [], {}),
    ):
        reset_all()
        t0 = time.perf_counter()
        paths = demo.main(["--model", model, "--arch", arch, "--iters", "20", "--path", scene,
                           "--out", os.path.join(outdir, arch), *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        expect_launches(launch_counts(), {k: v * len(paths) for k, v in per_pair.items()},
                        f"demo {arch}")
        shapes = [fu.read_png(p).shape for p in paths]
        dtypes = {fu.read_png(p).dtype for p in paths}
        log(f"data_eval demo {arch}: {len(paths)} PNGs {shapes} {dtypes} in {secs:.2f} s")
        if len(paths) != 2 or shapes != [(2 * SINTEL_HW[0], SINTEL_HW[1], 3)] * 2 \
                or dtypes != {np.dtype(np.uint8)}:
            raise AssertionError(f"data_eval: demo {arch} wrote {shapes}")
        out[arch] = {"pngs": len(paths), "seconds": secs}
    return out


def phase_data_eval(state):
    import shutil

    from raft_optical_flow_tpu_torch.data import native
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    t0 = time.perf_counter()
    shutil.rmtree(DATA_EVAL_DIR, ignore_errors=True)
    res = {}
    try:
        tb = time.perf_counter()
        lib = native.build()
        native.get_lib()
        res["native_build_s"] = time.perf_counter() - tb
        log(f"data_eval: native data library {lib.name} ready in {res['native_build_s']:.2f} s")
        roots, n_files, write_s = _write_trees(os.path.join(DATA_EVAL_DIR, "trees"))
        res["files"], res["write_s"] = n_files, write_s
        log(f"data_eval: wrote {n_files} files (Chairs 12 pairs at {CHAIRS_HW}, Sintel "
            f"{len(SINTEL_SCENES)} scenes x 3 frames x clean/final at {SINTEL_HW}, KITTI at "
            f"{KITTI_HWS}) in {write_s:.2f} s; each read back bit for bit")
        reset_all()
        res["chairs_stage"] = c = _chairs_stage(roots["chairs"], os.path.join(DATA_EVAL_DIR, "ck"))
        res["loader_pairs_per_s"] = _loader_rate(roots["chairs"])
        log(f"data_eval chairs stage (cli/train_raft, RAFT-standard fp32, BN training, batch 10, "
            f"{CHAIRS_CROP[0]}x{CHAIRS_CROP[1]}, {c['iters']} iterations): step ms "
            f"{[round(t, 3) for t in c['ms']]} (steps 2-3: {[round(t, 3) for t in c['ms_steps_2_3']]},"
            f" {c['pairs_per_s']:.2f} pairs/s), between step starts "
            f"{[round(t, 3) for t in c['ms_between_starts']]} ms, peak {c['peak_gib']:.2f} GiB, "
            f"losses {c['losses']}, launches/step {c['launches_per_step']}; validation "
            f"{c['validation']} with launches {c['validation_launches']}; the CLI took "
            f"{c['seconds']:.2f} s; FlowDataLoader (batch 10, 4 workers) "
            f"{res['loader_pairs_per_s']:.2f} pairs/s against the step's {c['pairs_per_s']:.2f}")
        sd = load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz"))
        res["validators"] = _validators(roots, sd)
        res["submissions"] = _submissions(roots, sd, os.path.join(DATA_EVAL_DIR, "submissions"))
        res["demo"] = _demos(roots["sintel"], os.path.join(DATA_EVAL_DIR, "demo"))
    finally:
        shutil.rmtree(DATA_EVAL_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    state["data_eval"] = res
    log(f"phase data_eval: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# the frame decoders (JPEG, Adam7 PNG) and the process-worker loader

FRAMES_DIR = os.path.join(REPO, "raft_optical_flow_tpu_torch", "_build", "frames")
JPEG_GOLDENS = os.path.join(REPO, "tests", "goldens", "jpeg")
GRAIN_STREAM = os.path.join(REPO, "tests", "goldens", "grain_stream.json")
PAIRS = {"huffman": ("frame_0001.jpg", "frame_0002.jpg"),  # Pillow, 4:2:0 q95
         "sof10": ("frame_0001_sof10.jpg", "frame_0002_sof10.jpg")}  # arithmetic, progressive
FRAMES_DEMO_ITERS = 20  # cli/demo.py's default
FRAMES_DECODES = 20  # reads per frame for the decode time


def _frame_fixtures(workdir):
    """Each committed fixture (tests/goldens/jpeg/small.npz: JPEGs written by
    Pillow and cv2, Adam7 PNGs of every colour type and depth) written to a
    file and read by `read_gen`, equal (dtype, shape, np.array_equal) to PIL's
    array stored beside it; the 436x1024 pair's arrays against the sha256 of
    PIL's (pair.json)."""
    import hashlib

    from raft_optical_flow_tpu_torch.data import frame_utils as fu

    g = np.load(os.path.join(JPEG_GOLDENS, "small.npz"))
    names = sorted(k[len("file/"):] for k in g.files if k.startswith("file/"))
    os.makedirs(workdir, exist_ok=True)
    for name in names:
        path = os.path.join(workdir, name)
        with open(path, "wb") as f:
            f.write(g[f"file/{name}"].tobytes())
        got, ref = fu.read_gen(path), g[f"pil/{name}"]
        if got.dtype != ref.dtype or got.shape != ref.shape or not np.array_equal(got, ref):
            raise AssertionError(f"frames: {name} decodes to {got.dtype} {got.shape}, not PIL's "
                                 f"{ref.dtype} {ref.shape} array")
    with open(os.path.join(JPEG_GOLDENS, "pair.json")) as f:
        digests = json.load(f)
    for name, want in sorted(digests.items()):
        got = fu.read_gen(os.path.join(JPEG_GOLDENS, name))
        if (list(got.shape) != want["shape"] or str(got.dtype) != want["dtype"]
                or hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"]):
            raise AssertionError(f"frames: {name} does not decode to PIL's array")
    n_jpeg = sum(n.endswith(".jpg") for n in names)
    n_coded = sum("@" in n for n in names)  # jpeg_writer.c's codings
    return {"jpeg": n_jpeg, "jpeg_codings": n_coded, "adam7_png": len(names) - n_jpeg,
            "pair": sorted(digests)}


def _decode_ms():
    """The median ms of FRAMES_DECODES reads of each 436x1024 JPEG of both
    pairs (read_jpeg: file read and native decode, one host thread)."""
    from raft_optical_flow_tpu_torch.data import frame_utils as fu

    out = {}
    for name in PAIRS["huffman"] + PAIRS["sof10"]:
        path = os.path.join(JPEG_GOLDENS, name)
        fu.read_jpeg(path)
        ts = []
        for _ in range(FRAMES_DECODES):
            t0 = time.perf_counter()
            fu.read_jpeg(path)
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"median_ms": float(np.median(ts)), "ms": ts}
    return out


def _jpeg_demo(workdir):
    """`cli/demo.main --small` (checkpoint, 20 iterations) on a folder of both
    JPEG pairs (frame_0001..6.jpg: Huffman 1, 2, SOF10 1, 2, Huffman 1, 2;
    pairs H1-H2, H2-A1, A1-A2 (the SOF10 pair), A2-H1, H1-H2) at 436x1024 on
    the card, under cudnn.deterministic: K1 and K2 20 launches each per
    pair; each pair's flow equal (torch.equal) to the same padded frames
    through the plain lookup (same weights); pairs 1 and 5 equal; each PNG
    read back as (2 x 436, 1024, 3) uint8; ms of each forward (host clock
    around a synchronize) and of the whole CLI."""
    import shutil

    from raft_optical_flow_tpu_torch.cli import demo
    from raft_optical_flow_tpu_torch.data import frame_utils as fu
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    ckpt = os.path.join(REPO, "checkpoints", "raft_small.npz")
    frames = os.path.join(workdir, "pair")
    os.makedirs(frames, exist_ok=True)
    for i, name in enumerate(PAIRS["huffman"] + PAIRS["sof10"] + PAIRS["huffman"]):
        shutil.copy(os.path.join(JPEG_GOLDENS, name), os.path.join(frames, f"frame_{i + 1:04d}.jpg"))
    rec = []

    def recording(make):
        def wrapped(*a, **k):
            fwd, needs_pad = make(*a, **k)

            def run(image1, image2):
                torch.cuda.synchronize()
                reset_all()
                t0 = time.perf_counter()
                flow = fwd(image1, image2)
                torch.cuda.synchronize()
                rec.append({"ms": (time.perf_counter() - t0) * 1e3, "launches": launch_counts(),
                            "inputs": (image1.clone(), image2.clone()), "flow": flow.clone()})
                return flow

            return run, needs_pad
        return wrapped

    with deterministic(algorithms=False):
        t0 = time.perf_counter()
        with _patched(demo, "_forward", recording):
            paths = demo.main(["--model", ckpt, "--small", "--iters", str(FRAMES_DEMO_ITERS),
                               "--path", frames, "--out", os.path.join(workdir, "demo")])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        plain = RAFT(RAFTConfig(small=True, corr_impl="plain"), device="cuda")
        plain.load_state_dict(load_flax_npz(ckpt))
        with torch.inference_mode():
            flows_plain = [plain(*r["inputs"], iters=FRAMES_DEMO_ITERS, test_mode=True)[1]
                           for r in rec]
    per_pair = {"corr_lookup_level": FRAMES_DEMO_ITERS,
                "corr_lookup_coarse_fused": FRAMES_DEMO_ITERS}
    for r in rec:
        expect_launches(r["launches"], per_pair, "frames demo pair")
    equal = [bool(torch.equal(r["flow"], p)) for r, p in zip(rec, flows_plain)]
    shapes = [fu.read_png(p).shape for p in paths]
    dtypes = {fu.read_png(p).dtype for p in paths}
    padded = tuple(rec[0]["inputs"][0].shape)
    if len(rec) != 5 or len(paths) != 5 or not all(equal):
        raise AssertionError(f"frames: demo flows through K1/K2 equal to the plain lookup's: "
                             f"{equal} ({len(rec)} pairs, {len(paths)} PNGs)")
    if not torch.equal(rec[0]["flow"], rec[4]["flow"]):
        raise AssertionError("frames: the same pair twice gave two flows")
    if torch.equal(rec[0]["flow"], rec[2]["flow"]):
        raise AssertionError("frames: the SOF10 pair gave the Huffman pair's flow")
    if shapes != [(2 * SINTEL_HW[0], SINTEL_HW[1], 3)] * 5 or dtypes != {np.dtype(np.uint8)}:
        raise AssertionError(f"frames: demo wrote {shapes} {dtypes}")
    if not all(torch.isfinite(r["flow"]).all() for r in rec):
        raise AssertionError("frames: demo flow not finite")
    mag = torch.linalg.vector_norm(rec[0]["flow"].float(), dim=-1)
    return {"pairs": len(rec), "padded": padded, "forward_ms": [r["ms"] for r in rec],
            "ms_per_pair": float(np.median([r["ms"] for r in rec[1:]])),
            "sof10_pair_ms": rec[2]["ms"], "sof10_launches": rec[2]["launches"],
            "cli_s": cli_s, "launches_per_pair": rec[0]["launches"], "flows_equal_plain": equal,
            "mean_abs_flow": float(mag.mean()), "max_abs_flow": float(mag.max())}


def _loader_pairs_per_s(make_iter, warm, batches):
    """A fresh iterator's first `warm` batches (seconds to the last of them:
    start-up), then pairs/s over `batches` more and the seconds at which each
    arrived; the batches it gave."""
    it = make_iter()
    t0 = time.perf_counter()
    got = [next(it) for _ in range(warm)]
    first = time.perf_counter() - t0
    t1 = time.perf_counter()
    stamps = []
    for _ in range(batches):
        got.append(next(it))
        stamps.append(time.perf_counter() - t1)
    it.close()
    rate = sum(len(b["flow"]) for b in got[warm:]) / stamps[-1]
    return {"warm_s": first, "pairs_per_s": rate, "arrivals_s": stamps}, got


def _grain_loader(workdir, batches=6):
    """The chairs stage (10 training pairs at 384x512, 368x496 crops) through
    GrainFlowLoader (batch 10) in-process and with 4 worker processes: every
    record of every batch equal to the (seed, i) draw of the index grain's
    DataLoader gives at that batch and place with worker_count 0 and 4
    (tests/goldens/grain_stream.json, written with grain by
    tests/torch_jpeg_fixtures.py); pairs/s of the processes (after one batch
    a worker) and of FlowDataLoader with 4 threads (after one batch) over
    `batches` batches, and in-process over 3."""
    from raft_optical_flow_tpu_torch.data.datasets import fetch_dataset
    from raft_optical_flow_tpu_torch.data.grain_pipeline import GrainFlowLoader, _FlowRecordSource
    from raft_optical_flow_tpu_torch.data.pipeline import FlowDataLoader

    with open(GRAIN_STREAM) as f:
        golden = json.load(f)
    roots, n_files, _ = _write_trees(workdir, datasets=("chairs",))
    ds = fetch_dataset("chairs", CHAIRS_CROP, roots={"chairs": roots["chairs"]})
    if (len(ds), golden["batch_size"], golden["seed"]) != (golden["num_records"], 10, 1234):
        raise AssertionError(f"frames: {len(ds)} records against the golden's "
                             f"{golden['num_records']}")
    out = {"files": n_files, "records": len(ds)}
    got = {}
    for workers, warm, n in ((0, 1, 3), (4, 4, batches)):
        out[f"grain_{workers}"], got[workers] = _loader_pairs_per_s(
            lambda w=workers: iter(GrainFlowLoader(ds, 10, num_workers=w, seed=1234)), warm, n)
    out["threads_4"], _ = _loader_pairs_per_s(
        lambda: FlowDataLoader(ds, batch_size=10, num_workers=4, seed=1234).epochs(), 1, batches)
    src = _FlowRecordSource(ds, 1234)
    draws = {}
    for workers, batches_got in got.items():
        want = golden["batches"][str(workers)]
        if len(batches_got) > len(want):
            raise AssertionError(f"frames: {len(batches_got)} batches, the golden has {len(want)}")
        for j, batch in enumerate(batches_got):
            for r, i in enumerate(want[j]):
                if i not in draws:
                    draws[i] = src[i]
                if not all(np.array_equal(batch[k][r], draws[i][k]) for k in draws[i]):
                    raise AssertionError(f"frames: GrainFlowLoader ({workers} workers) batch {j} "
                                         f"record {r} is not record {i}, grain's")
        out[f"grain_{workers}"]["records_checked"] = 10 * len(batches_got)
    if got[4][0]["image1"].shape != (10, *CHAIRS_CROP, 3):
        raise AssertionError(f"frames: loader batch {got[4][0]['image1'].shape}")
    return out


def phase_frames(state):
    import shutil

    from raft_optical_flow_tpu_torch.data import native

    t0 = time.perf_counter()
    shutil.rmtree(FRAMES_DIR, ignore_errors=True)
    res = {}
    tb = time.perf_counter()
    native.get_lib()
    res["native_build_s"] = time.perf_counter() - tb
    res["fixtures"] = fx = _frame_fixtures(os.path.join(FRAMES_DIR, "fixtures"))
    log(f"frames fixtures: {fx['jpeg']} JPEGs ({fx['jpeg_codings']} of them arithmetic, "
        f"lossless, YCCK or smoothed progressive) and {fx['adam7_png']} Adam7 PNGs equal to "
        f"PIL's arrays, the pairs {fx['pair']} to PIL's sha256 (native library ready in "
        f"{res['native_build_s']:.2f} s)")
    res["decode"] = dec = _decode_ms()
    log("frames decode (read_jpeg, 436x1024 4:2:0, Huffman q95 and SOF10 q90, one host thread, "
        f"median of {FRAMES_DECODES}): " + ", ".join(f"{k} {v['median_ms']:.3f} ms"
                                                    for k, v in dec.items()))
    reset_all()
    res["demo"] = d = _jpeg_demo(FRAMES_DIR)
    log(f"frames demo (cli/demo RAFT-small, {FRAMES_DEMO_ITERS} iterations, JPEG pairs "
        f"{SINTEL_HW} padded to {d['padded']}): {d['pairs']} pairs, forward ms "
        f"{[round(t, 3) for t in d['forward_ms']]} ({d['ms_per_pair']:.3f} ms/pair after the "
        f"first; the SOF10 pair {d['sof10_pair_ms']:.3f}), the CLI {d['cli_s']:.2f} s; launches "
        f"per pair {d['launches_per_pair']} (SOF10 pair {d['sof10_launches']}); flows equal to "
        f"the plain lookup's {d['flows_equal_plain']}; |flow| mean {d['mean_abs_flow']:.3f} max "
        f"{d['max_abs_flow']:.3f}")
    res["loader"] = lo = _grain_loader(os.path.join(FRAMES_DIR, "trees"))
    log(f"frames loader (chairs {lo['records']} pairs, batch 10, {CHAIRS_CROP} crops): "
        f"GrainFlowLoader in-process {lo['grain_0']['pairs_per_s']:.2f} pairs/s, 4 worker "
        f"processes {lo['grain_4']['pairs_per_s']:.2f} (4 batches first in "
        f"{lo['grain_4']['warm_s']:.2f} s; arrivals "
        f"{[round(t, 2) for t in lo['grain_4']['arrivals_s']]} s), FlowDataLoader 4 "
        f"threads {lo['threads_4']['pairs_per_s']:.2f} (first batch "
        f"{lo['threads_4']['warm_s']:.2f} s; arrivals "
        f"{[round(t, 2) for t in lo['threads_4']['arrivals_s']]} s); records in grain's order "
        f"({lo['grain_0']['records_checked']} in-process, {lo['grain_4']['records_checked']} "
        f"from the processes)")
    shutil.rmtree(FRAMES_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    state["frames"] = res
    log(f"phase frames: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# the utils: export through K1/K2's custom ops, reference-checkpoint
# conversion, gradient parity, profiling, TensorBoard logging

UTILS_DIR = os.path.join(REPO, "raft_optical_flow_tpu_torch", "_build", "utils")
EXPORT_ITERS = 20  # utils/export.py's defaults (the JAX package's): batch 1,
EXPORT_RAFT_HW = (440, 1024)  # RAFT 440x1024 in test mode,
EXPORT_LFN3_HW = (384, 1024)  # LiteFlowNet3 384x1024
UTILS_PHASE_LIMIT_S = 150.0


def _export_raft():
    """RAFT-small (checkpoint) exported at the JAX defaults, saved, loaded
    back and run on the card: its flow equal to the eager model's, K1 and
    K2 EXPORT_ITERS launches each per exported call; ms per call of both."""
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.export import export_raft, load_exported
    from raft_optical_flow_tpu_torch.utils.profiling import time_fn
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    sd = load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    path = os.path.join(UTILS_DIR, "raft_small.pt2")
    t0 = time.perf_counter()
    export_raft(sd, path, small=True)
    t1 = time.perf_counter()
    program = load_exported(path)
    t2 = time.perf_counter()
    eager = RAFT(RAFTConfig(small=True), device="cuda")
    eager.load_state_dict(sd)
    _, a, b = _serving_inputs(1, seed=21)
    assert tuple(a.shape) == (1, *EXPORT_RAFT_HW, 3)
    reset_all()
    got = program(a, b)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(launches, {"corr_lookup_level": EXPORT_ITERS,
                               "corr_lookup_coarse_fused": EXPORT_ITERS}, "exported RAFT-small")
    want = eager(a, b, iters=EXPORT_ITERS)[1]
    if got.shape != want.shape or not torch.equal(got, want):
        d = float((got - want).abs().max()) if got.shape == want.shape else None
        raise AssertionError(f"exported RAFT-small differs from eager: max|d|={d!r}")
    ms_exp, _ = time_fn(program, a, b, num_reps=5, device="cuda")
    ms_eager, _ = time_fn(lambda: eager(a, b, iters=EXPORT_ITERS)[1], num_reps=5, device="cuda")
    res = {"export_s": t1 - t0, "load_s": t2 - t1, "bytes": os.path.getsize(path),
           "launches": launches, "ms_exported": ms_exp, "ms_eager": ms_eager, "flow": got[0]}
    log(f"utils export RAFT-small 1x{EXPORT_RAFT_HW[0]}x{EXPORT_RAFT_HW[1]}, {EXPORT_ITERS} "
        f"iterations, fp32: exported in {res['export_s']:.2f} s ({res['bytes'] / 2**20:.1f} MiB "
        f".pt2), loaded in {res['load_s']:.2f} s; flow equal to eager (torch.equal); launches "
        f"per exported call {launches}; ms/call exported {ms_exp:.3f}, eager {ms_eager:.3f} "
        f"(median of 5 after a warm-up, CUDA events)")
    return res


def _export_lfn3():
    """LiteFlowNet3 (the goldens' params) exported at 1x384x1024, loaded back
    and run: flows and confs equal to eager's, no port kernel launched."""
    from raft_optical_flow_tpu_torch.models import LFN3Config, LiteFlowNet3
    from raft_optical_flow_tpu_torch.utils.export import export_lfn3, load_exported
    from raft_optical_flow_tpu_torch.utils.profiling import time_fn
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_npz

    sd = load_flax_npz(os.path.join(REPO, "tests", "goldens", "lfn3_standard_params.npz"))
    path = os.path.join(UTILS_DIR, "lfn3.pt2")
    t0 = time.perf_counter()
    export_lfn3(sd, path)
    t1 = time.perf_counter()
    program = load_exported(path)
    t2 = time.perf_counter()
    eager = LiteFlowNet3(LFN3Config(), device="cuda")
    eager.load_state_dict(sd)
    g = torch.Generator(device="cuda").manual_seed(22)
    images = torch.rand(1, 2, *EXPORT_LFN3_HW, 3, device="cuda", generator=g)
    reset_all()
    flows, confs = program(images)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {}, "exported LiteFlowNet3")
    want = eager(images)
    if not (torch.equal(flows, want["flows"]) and torch.equal(confs, want["confs"])):
        d = max(float((flows - want["flows"]).abs().max()),
                float((confs - want["confs"]).abs().max()))
        raise AssertionError(f"exported LiteFlowNet3 differs from eager: max|d|={d!r}")
    ms_exp, _ = time_fn(program, images, num_reps=5, device="cuda")
    ms_eager, _ = time_fn(lambda: eager(images)["flows"], num_reps=5, device="cuda")
    res = {"export_s": t1 - t0, "load_s": t2 - t1, "ms_exported": ms_exp, "ms_eager": ms_eager}
    log(f"utils export LiteFlowNet3 1x{EXPORT_LFN3_HW[0]}x{EXPORT_LFN3_HW[1]} fp32: exported in "
        f"{res['export_s']:.2f} s, loaded in {res['load_s']:.2f} s; flows and confs equal to "
        f"eager (torch.equal); ms/call exported {ms_exp:.3f}, eager {ms_eager:.3f}")
    return res


def _conversion():
    """Reference-named checkpoints written from the .npz files (RAFT-small
    with `module.` prefixes; LiteFlowNet3 in a Lightning wrapper with
    `model.` prefixes), converted by `utils/torch_convert.py`, loaded
    strict=True: forwards bit for bit with the .npz models'."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_reference_names import reference_state_dict

    from raft_optical_flow_tpu_torch.models import RAFT, LFN3Config, LiteFlowNet3, RAFTConfig
    from raft_optical_flow_tpu_torch.utils import torch_convert
    from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint, load_flax_npz

    out = {}
    npz = os.path.join(REPO, "checkpoints", "raft_small.npz")
    path = os.path.join(UTILS_DIR, "raft-small.pth")
    torch.save({"module." + k: v
                for k, v in reference_state_dict(load_flax_checkpoint(npz), raft=True).items()},
               path)
    g = np.load(os.path.join(REPO, "tests", "goldens", "raft_small.npz"))
    a = torch.from_numpy(g["image1"]).float()[None].cuda()
    b = torch.from_numpy(g["image2"]).float()[None].cuda()
    flows = []
    for sd in (torch_convert.convert_raft_checkpoint(path), load_flax_npz(npz)):
        model = RAFT(RAFTConfig(small=True), device="cuda")
        model.load_state_dict(sd, strict=True)
        flows.append(model(a, b, iters=int(g["iters"]))[1])
    out["raft_small"] = torch.equal(*flows)

    npz = os.path.join(REPO, "tests", "goldens", "lfn3_standard_params.npz")
    path = os.path.join(UTILS_DIR, "lfn3.ckpt")
    sd_ref = reference_state_dict(load_flax_checkpoint(npz), raft=False)
    torch.save({"epoch": 1, "state_dict": {"model." + k: v for k, v in sd_ref.items()}}, path)
    gen = torch.Generator(device="cuda").manual_seed(23)
    images = torch.rand(1, 2, *EXPORT_LFN3_HW, 3, device="cuda", generator=gen)
    flows = []
    for sd in (torch_convert.convert_lfn3_checkpoint(path), load_flax_npz(npz)):
        model = LiteFlowNet3(LFN3Config(), device="cuda")
        model.load_state_dict(sd, strict=True)
        flows.append(model(images)["flows"])
    out["lfn3_lightning"] = torch.equal(*flows)
    log(f"utils conversion: reference-named .pth loaded strict=True, forward bit for bit with "
        f"the .npz model: {out}")
    if not all(out.values()):
        raise AssertionError(f"a converted checkpoint's forward differs: {out}")
    return out


def _profiling(state):
    """compare_models() at its defaults; memory_analysis of RAFT-standard
    bf16 at batch 16, 1024x440, 32 iterations; InputPadder's pad copies
    nothing beyond its output."""
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.ops.padding import InputPadder
    from raft_optical_flow_tpu_torch.utils import profiling

    table = profiling.compare_models()
    for name, row in table.items():
        log(f"utils compare_models 1x256x448 fp32 [{state['smi']}] {name}: {json.dumps(row)}")
    model = RAFT(RAFTConfig(small=False, compute_dtype=torch.bfloat16), device="cuda",
                 generator=torch.Generator().manual_seed(0))
    _, a, b = _serving_inputs(16, seed=24)
    mem = profiling.memory_analysis(lambda x, y: model(x, y, iters=ITERS), a, b)
    log(f"utils memory_analysis RAFT-standard bf16 16x440x1024, {ITERS} iterations "
        f"[{state['smi']}]: {json.dumps(mem)}")
    del a, b
    frame = torch.rand(1, *SERVE_HW, 3, device="cuda")
    pad = profiling.memory_analysis(InputPadder(frame.shape).pad, frame)
    log(f"utils InputPadder.pad 1x{SERVE_HW[0]}x{SERVE_HW[1]}x3 fp32: {json.dumps(pad)}")
    if pad["temp_mb"] > 0.01 * pad["output_mb"]:
        raise AssertionError(f"InputPadder.pad held {pad['temp_mb']} MiB beyond its output")
    return {"compare_models": table, "memory_raft_standard_bf16_bs16": mem, "pad": pad}


def _dispatch_cost(n=500):
    """Host µs per call of K1 and K2 at the batch-1 serving shapes (bf16,
    radius 4, 1024x440: level 0 55x128, Q = 7040): the direct ctypes
    wrapper against the custom op, in turns (direct, op, op, direct), each
    n calls between two synchronizes."""
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck

    h, w = EXPORT_RAFT_HW[0] // 8, EXPORT_RAFT_HW[1] // 8
    pyr = [p.contiguous() for p in serving_pyramid(1, h, w, torch.bfloat16, seed=25)]
    flat = serving_coords(1, h, w, seed=26).reshape(1, h * w, 2)
    calls = {
        "K1 direct": lambda: ck.corr_lookup_level(pyr[0], flat, 4, torch.bfloat16),
        "K1 op": lambda: torch.ops.raft_port.corr_lookup_level(pyr[0], flat, 4, torch.bfloat16),
        "K2 direct": lambda: ck.corr_lookup_coarse_fused(pyr[1:], flat, 4, torch.bfloat16),
        "K2 op": lambda: torch.ops.raft_port.corr_lookup_coarse_fused(pyr[1:], flat, 4,
                                                                      torch.bfloat16),
    }
    out = {}
    for k in ("K1", "K2"):
        direct, op = calls[f"{k} direct"], calls[f"{k} op"]
        if not torch.equal(direct(), op()):
            raise AssertionError(f"{k}: the op and the direct wrapper differ")
        for name, fn in ((f"{k} direct", direct), (f"{k} op", op), (f"{k} op", op),
                         (f"{k} direct", direct)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            out.setdefault(name, []).append((time.perf_counter() - t0) * 1e6 / n)
    log(f"utils dispatch, host us per call at the batch-1 serving shapes (bf16, r=4, "
        f"{n} calls between synchronizes; direct, op, op, direct): "
        f"{ {k: [round(v, 2) for v in vs] for k, vs in out.items()} }")
    return out


def _pad_layout(state):
    """RAFT-standard bf16 serving at batch 16 on InputPadder's output
    (contiguous NHWC, so the convs see channels-last tensors) against the
    same frames as an NHWC view of contiguous NCHW memory (what the pad
    returned before it padded NHWC in place), in turns; each the median of
    2 after a warm-up, and the two flows' EPE."""
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.utils.profiling import time_fn

    model = RAFT(RAFTConfig(small=False, compute_dtype=torch.bfloat16), device="cuda",
                 generator=torch.Generator().manual_seed(0))
    _, a, b = _serving_inputs(16, seed=16)
    views = {"nhwc": (a, b),
             "nchw_view": tuple(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                                for x in (a, b))}
    ms, flows = {}, {}
    for name in ("nhwc", "nchw_view", "nchw_view", "nhwc"):
        x, y = views[name]
        t, flows[name] = time_fn(lambda: model(x, y, iters=ITERS)[1], num_reps=2, device="cuda")
        ms.setdefault(name, []).append(t)
    epe = float(torch.linalg.norm(flows["nhwc"] - flows["nchw_view"], dim=-1).mean())
    log(f"utils pad layout, RAFT-standard bf16 16x440x1024 [{state['smi']}]: ms/call "
        f"{ {k: [round(v, 3) for v in vs] for k, vs in ms.items()} } (median of 2 after a "
        f"warm-up, in turns); EPE between the two {epe!r}")
    if not epe < 0.02:
        raise AssertionError("the two layouts disagree")
    return {"ms": ms, "epe": epe}


def _tensorboard(flow):
    """Scalars and a flow image through TensorBoardWriter, read back: every
    CRC, the tags, steps and values, the image's pixels."""
    from raft_optical_flow_tpu_torch.utils import logging as tblog
    from raft_optical_flow_tpu_torch.utils.flow_viz import flow_to_image

    writer = tblog.TensorBoardWriter(os.path.join(UTILS_DIR, "tb"))
    scalars = [("train/loss", 2.5, 0), ("train/epe", 1.25, 10), ("val/epe", 0.75, 100)]
    for tag, value, step in scalars:
        writer.add_scalar(tag, value, step)
    image = flow_to_image(flow.float().cpu().numpy())
    writer.add_flow_image("val/flow", flow.float().cpu().numpy(), 100)
    writer.close()
    events = tblog.read_event_file(writer.path)
    got = [(v["tag"], v.get("simple_value"), e["step"])
           for e in events for v in e.get("values", [])]
    if events[0].get("file_version") != "brain.Event:2" or \
            got != scalars + [("val/flow", None, 100)]:
        raise AssertionError(f"event file read back as {got}")
    img = events[-1]["values"][0]["image"]
    if not np.array_equal(img["pixels"], image):
        raise AssertionError("the event file's image differs from flow_to_image's")
    log(f"utils TensorBoardWriter: {len(events)} records, every CRC checked, tags, steps and "
        f"values read back, image {img['height']}x{img['width']} equal "
        f"({os.path.getsize(writer.path)} bytes)")
    return len(events)


def phase_utils(state):
    import shutil

    from raft_optical_flow_tpu_torch.utils import grad_parity

    t0 = time.perf_counter()
    shutil.rmtree(UTILS_DIR, ignore_errors=True)
    os.makedirs(UTILS_DIR)
    res = {}
    try:
        reset_all()
        res["export_raft"] = _export_raft()
        res["export_lfn3"] = _export_lfn3()
        res["conversion"] = _conversion()
        reset_all()
        res["grad_parity"] = gp = grad_parity.run_all()
        log(f"utils grad_parity.run_all(): {json.dumps(gp)}; launches {launch_counts()}")
        if not all(v["ok"] for v in gp.values()):
            raise AssertionError(f"grad parity failed: {gp}")
        res["dispatch_us"] = _dispatch_cost()
        res["profiling"] = _profiling(state)
        res["pad_layout"] = _pad_layout(state)
        res["events"] = _tensorboard(res["export_raft"].pop("flow"))
    finally:
        shutil.rmtree(UTILS_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    state["utils"] = res
    if res["seconds"] > UTILS_PHASE_LIMIT_S:
        raise AssertionError(f"phase utils took {res['seconds']:.1f} s (limit "
                             f"{UTILS_PHASE_LIMIT_S} s)")
    log(f"phase utils: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase parallel: data parallelism (`parallel/`), each check in fresh
# processes started by this script (`--parallel-worker`), so that this
# process holds no process group

PARALLEL_DIR = os.path.join(REPO, "raft_optical_flow_tpu_torch", "_build", "parallel")
PARALLEL_B = 2  # (a): the batch; (b): the rows of each of the two ranks
PARALLEL_TIMED = 5  # steps timed after the compared one, (a) in turns
SPATIAL_HW = (56, 128)  # fmap rows that split in two (the serving fmap's 55 do not)


def _parallel_stage(batch_size):
    """RAFT-standard fp32 at the chairs stage: BatchNorm training, 368x496,
    12 iterations."""
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import StageConfig

    stage = StageConfig(name="parallel", stage="chairs", num_steps=1000, batch_size=batch_size,
                        lr=4e-4, image_size=TRAIN_HW, freeze_bn=False, iters=TRAIN_ITERS)
    return stage, RAFTConfig()


def _trainer_step(trainer, batch):
    """One train step of `trainer` from launch counts of 0: (metrics as
    floats, launches, ms on the host clock around a synchronize)."""
    torch.cuda.synchronize()
    reset_all()
    t0 = time.perf_counter()
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {k: float(v) for k, v in metrics.items()}, launch_counts(), ms


def _trained(trainer):
    """The trainer's model after its step, on the CPU: parameters, their
    gradients and the buffers (BatchNorm statistics)."""
    m = trainer.model
    return {"params": {k: p.detach().cpu() for k, p in m.named_parameters()},
            "grads": {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
            "buffers": {k: b.detach().cpu() for k, b in m.named_buffers()}}


def _worker_nccl1(port):
    """(a) The chairs step at batch 2 without a process group, then through
    the mesh path of an NCCL group of one process; the same weights (seed)
    and batch. Then PARALLEL_TIMED more steps of each, in turns, for their
    times."""
    from raft_optical_flow_tpu_torch.parallel import distributed
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer

    stage, cfg = _parallel_stage(PARALLEL_B)
    batch = _train_batch(PARALLEL_B, seed=301)
    out = {}
    with deterministic(False):
        plain = RAFTTrainer(stage, cfg, device="cuda")
        out["plain"] = _trainer_step(plain, batch)
        out["plain_state"] = _trained(plain)
        if not distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda"):
            raise AssertionError("parallel (a): no process group")
        mesh = make_mesh()
        if torch.distributed.get_backend(mesh.group("data")) != "nccl":
            raise AssertionError("parallel (a): the data group is not NCCL")
        grouped = RAFTTrainer(stage, cfg, mesh=mesh)
        out["group"] = _trainer_step(grouped, batch)
        out["group_state"] = _trained(grouped)
        out["ms_plain"], out["ms_group"] = [], []
        for _ in range(PARALLEL_TIMED):
            out["ms_plain"].append(_trainer_step(plain, batch)[2])
            out["ms_group"].append(_trainer_step(grouped, batch)[2])
    return out


def _worker_gloo2(world, rank, port):
    """(b) The chairs step at global batch 4: rank `rank` of two gloo
    processes on the one card (CUDA tensors), each on its 2 rows, or (world
    1) one process on all 4 rows without a group; then PARALLEL_TIMED more
    steps for their times (the two ranks share the card)."""
    from raft_optical_flow_tpu_torch.parallel import distributed
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer

    stage, cfg = _parallel_stage(2 * PARALLEL_B)
    batch = _train_batch(2 * PARALLEL_B, seed=302)
    mesh = None
    if world > 1:
        distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda")
        mesh = make_mesh()
        batch = shard_batch(batch, mesh)
    with deterministic(False):
        trainer = RAFTTrainer(stage, cfg, mesh=mesh)
        metrics, launches, ms = _trainer_step(trainer, batch)
        out = {"step": (metrics, launches, ms), "state": _trained(trainer),
               "generator": trainer.state.generator.get_state()}
        out["ms"] = [_trainer_step(trainer, batch)[2] for _ in range(PARALLEL_TIMED)]
    return out


def _worker_spatial(world, rank, port):
    """(c) K4 on each gloo rank's slab of a 56x128 fmap (C = 256, 4 levels,
    radius 4), fp32 and bf16, the slabs gathered, against one K4 call on
    the whole frame; and the serving fmap's 55 rows refused."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.parallel import distributed
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh
    from raft_optical_flow_tpu_torch.parallel.spatial import (
        all_gather_rows,
        spatial_sharded_ondemand_corr,
    )

    distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", device="cuda")
    mesh = make_mesh(axis_names=("space",))
    h, w = SPATIAL_HW
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        f1, levels = ondemand_inputs(1, h, w, dt, seed=310)
        f1 = f1.reshape(1, h, w, -1)
        coords = serving_coords(1, h, w, seed=311)
        try:
            spatial_sharded_ondemand_corr(f1[:, 1:], levels, coords[:, 1:], 4, mesh, out_dtype=dt)
            raised = False
        except ValueError:
            raised = True
        torch.cuda.synchronize()
        co.reset_launches()
        slab = spatial_sharded_ondemand_corr(f1, levels, coords, 4, mesh, out_dtype=dt)
        torch.cuda.synchronize()
        launches = co.LAUNCHES["corr_ondemand_fwd"]
        routes = co.corr_ondemand_fwd_routes() if dt == torch.bfloat16 else None
        whole = all_gather_rows(slab, mesh)
        ref = co.ondemand_corr_pyramid_cuda(f1, levels, coords, 4, out_dtype=dt)
        ref_routes = co.corr_ondemand_fwd_routes() if dt == torch.bfloat16 else None
        out[str(dt)] = {"raised_55": raised, "launches": launches, "routes": routes,
                        "routes_whole": ref_routes,
                        "equal": bool(torch.equal(whole, ref)),
                        "max_abs": float((whole.float() - ref.float()).abs().max()),
                        "slab_rows": slab.shape[1], "shape": tuple(whole.shape)}
    return out


def parallel_worker(check, world, rank, port):
    """Entry of a `--parallel-worker` process: run the check and save what
    it returns under PARALLEL_DIR."""
    from raft_optical_flow_tpu_torch.kernels import _build
    from raft_optical_flow_tpu_torch.parallel import distributed

    if not _build.library_path().exists():
        raise RuntimeError("parallel worker: the kernels are not built (phase device builds them)")
    try:
        if check == "nccl1":
            out = _worker_nccl1(port)
        elif check == "gloo2":
            out = _worker_gloo2(world, rank, port)
        elif check == "multicard":
            out = _worker_multicard(world, rank, port)
        else:
            out = _worker_spatial(world, rank, port)
    finally:
        distributed.shutdown()
    torch.save(out, os.path.join(PARALLEL_DIR, f"{check}_{world}_{rank}.pt"))
    return 0


def _run_workers(check, ranks, world, timeout=600.0, env_of=None):
    """Start this script as `--parallel-worker` processes (one per rank in
    `ranks`; env_of(rank): variables added to its environment), wait for
    all (timeout: seconds for the whole run; a worker that fails or outlasts
    it ends the others), and load what each saved."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker",
                               check, str(world), str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                              env=dict(os.environ, **(env_of(r) if env_of else {})))
             for r in ranks]
    t0 = time.perf_counter()
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(timeout - (time.perf_counter() - t0), 1.0))
            if p.returncode != 0:
                raise AssertionError(f"parallel {check} worker failed:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [torch.load(os.path.join(PARALLEL_DIR, f"{check}_{world}_{r}.pt"), weights_only=False)
            for r in ranks]


def _max_abs(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


def _parallel_nccl1():
    (out,) = _run_workers("nccl1", [0], 1)
    (m0, l0, _), (m1, l1, _) = out["plain"], out["group"]
    a, b = out["plain_state"], out["group_state"]
    same = {part: all(torch.equal(a[part][k], b[part][k]) for k in a[part]) for part in a}
    expect = {"corr_lookup_level": 4 * TRAIN_ITERS, "corr_lookup_level_bwd": 4 * TRAIN_ITERS}
    expect_launches(l1, expect, "parallel (a) mesh step")
    expect_launches(l0, expect, "parallel (a) plain step")
    res = {"loss_equal": m0["loss"] == m1["loss"], "metrics_equal": m0 == m1, **same,
           "launches": l1, "ms_plain": out["ms_plain"], "ms_group": out["ms_group"],
           "median_ms_plain": float(np.median(out["ms_plain"])),
           "median_ms_group": float(np.median(out["ms_group"])),
           "max_abs": {part: _max_abs(a[part], b[part]) for part in a}}
    log(f"parallel (a) NCCL world 1 on cuda:0 against no group, RAFT-standard chairs step "
        f"(fp32, BN training, batch {PARALLEL_B}, {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_ITERS} "
        f"iterations, cudnn.deterministic): loss {m1['loss']!r} equal {res['loss_equal']}, "
        f"metrics equal {res['metrics_equal']}, grads equal {same['grads']}, params equal "
        f"{same['params']}, buffers equal {same['buffers']} (max |d| {res['max_abs']}); "
        f"launches {l1}; ms/step without the group {out['ms_plain']} (median "
        f"{res['median_ms_plain']:.2f}), with it {out['ms_group']} (median "
        f"{res['median_ms_group']:.2f})")
    if not (res["metrics_equal"] and all(same.values())):
        raise AssertionError(f"parallel (a): the world-1 mesh step is not the plain step: {res}")
    return res


def _parallel_gloo2():
    r0, r1 = _run_workers("gloo2", [0, 1], 2)
    (ref,) = _run_workers("gloo2", [0], 1)
    (m0, l0, ms0), (m1, _, _), (mr, _, msr) = r0["step"], r1["step"], ref["step"]
    replicated = (m0 == m1 and torch.equal(r0["generator"], r1["generator"]) and all(
        torch.equal(r0["state"][part][k], r1["state"][part][k])
        for part in ("params", "buffers") for k in r0["state"][part]))
    rel = {k: abs(m0[k] - mr[k]) / max(abs(mr[k]), 1e-30) for k in mr}
    close = all(abs(m0[k] - mr[k]) <= 1e-5 * abs(mr[k]) + 1e-6 for k in mr)
    pa, pr = r0["state"]["params"], ref["state"]["params"]
    d = torch.cat([(pa[k].double() - pr[k].double()).abs().flatten() for k in pr])
    frac = float((d > 1e-6).double().mean())
    bn = {k: v for k, v in r0["state"]["buffers"].items() if "running" in k}
    bn_d = _max_abs(bn, {k: ref["state"]["buffers"][k] for k in bn})
    expect_launches(l0, {"corr_lookup_level": 4 * TRAIN_ITERS,
                         "corr_lookup_level_bwd": 4 * TRAIN_ITERS}, "parallel (b) rank 0 step")
    res = {"replicated_equal": replicated, "metrics_rel": rel, "params_max_abs": float(d.max()),
           "params_frac_over_1e-6": frac, "bn_max_abs": bn_d, "launches": l0,
           "ms_rank0": r0["ms"], "ms_rank1": r1["ms"], "ms_single": ref["ms"],
           "median_ms_rank0": float(np.median(r0["ms"])),
           "median_ms_single": float(np.median(ref["ms"])),
           "generator_equal": bool(torch.equal(r0["generator"], ref["generator"]))}
    log(f"parallel (b) two gloo ranks on the one card (CUDA tensors), {PARALLEL_B} rows each, "
        f"against one process at batch {2 * PARALLEL_B} (the chairs step): ranks equal "
        f"{replicated}; metrics rel {rel} (gate rel 1e-5 + abs 1e-6); params max |d| "
        f"{res['params_max_abs']!r}, {frac:.4%} over 1e-6 (gates 1e-3, 1%); BN running "
        f"statistics max |d| {bn_d!r} (gate 1e-5; {len(bn)} tensors); generator equal "
        f"{res['generator_equal']}; launches {l0}; first step ms rank 0 {ms0:.1f}, single "
        f"{msr:.1f}; then ms/step rank 0 {r0['ms']} (median {res['median_ms_rank0']:.2f}), "
        f"rank 1 {r1['ms']}, single {ref['ms']} (median {res['median_ms_single']:.2f})")
    if not (replicated and close and res["params_max_abs"] < 1e-3 and frac < 0.01
            and bn_d <= 1e-5 and res["generator_equal"]):
        raise AssertionError(f"parallel (b): two processes are not the one-process step: {res}")
    return res


def _parallel_spatial():
    r0, r1 = _run_workers("spatial", [0, 1], 2)
    log(f"parallel (c) spatial K4, two gloo ranks, fmap {SPATIAL_HW[0]}x{SPATIAL_HW[1]} (C=256, "
        f"4 levels, radius 4), slabs gathered against one K4 call on the frame: rank 0 {r0}, "
        f"rank 1 {r1}")
    for r in (r0, r1):
        for dt, v in r.items():
            if not (v["equal"] and v["raised_55"] and v["launches"] == 1
                    and v["slab_rows"] == SPATIAL_HW[0] // 2):
                raise AssertionError(f"parallel (c) {dt}: {v}")
    return r0


def phase_parallel(state):
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    try:
        res = {"nccl1": _parallel_nccl1(), "gloo2": _parallel_gloo2(),
               "spatial": _parallel_spatial()}
    finally:
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    state["parallel"] = res
    log(f"phase parallel: ok in {res['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase multicard: every visible card (two or more), one NCCL process each,
# started by this script (`--parallel-worker multicard`) after phase device
# has built the kernels; the one-card references run in process 0 on cuda:0

MULTICARD_DIR = os.path.join(REPO, "raft_optical_flow_tpu_torch", "_build", "multicard")
MC_BATCH = 8  # (a): the global batch (2 rows a card on four)
MC_TIMED = 5  # steps timed after the compared one, each side
MC_SPATIAL_HW = (64, 128)  # (c): the fmap (16-row slabs on four cards: K4's 4-row tiles)
MC_WORKER_TIMEOUT_S = 240.0
MC_PHASE_LIMIT_S = 300.0
# cuDNN picks deterministic algorithms in every process of check (d) (no
# flag of the CLI does it): imported first by each Python the check starts
MC_SITECUSTOMIZE = "import torch\ntorch.backends.cudnn.deterministic = True\n"


def _digest(tensors):
    """sha256 of the tensors' bytes, in order (ranks compare without
    shipping their states)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
                 if t.numel() else b"")
    return h.hexdigest()


def _mc_step(trainer, batch, n_timed, full=True):
    """The step compared (from launch counts of 0), then n_timed more for
    their ms (host clock around a synchronize; under NCCL each step ends
    with every rank's all-reduce). The parameters and buffers after the
    first step go with the result when `full`, else only their digest."""
    metrics, launches, ms0 = _trainer_step(trainer, batch)
    m = trainer.model
    params = {k: p.detach().cpu() for k, p in m.named_parameters()}
    buffers = {k: b.detach().cpu() for k, b in m.named_buffers()}
    out = {"metrics": metrics, "launches": launches, "ms_first": ms0,
           "generator": trainer.state.generator.get_state(),
           "digest": _digest(list(params.values()) + list(buffers.values()))}
    if full:
        out.update(params=params, buffers=buffers)
    out["ms"] = [_trainer_step(trainer, batch)[2] for _ in range(n_timed)]
    return out


def _nccl_profile(trainer, batch):
    """One more step under torch.profiler (CPU and CUDA activity): device ms
    of the NCCL kernels (the gradient and BatchNorm all-reduces, each
    including its wait for the other ranks) and of every kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    nccl = device = 0.0
    calls = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = float(us if us is not None else e.self_cuda_time_total)
        device += us
        if "nccl" in e.key.lower():
            nccl += us
            calls += e.count
    return {"nccl_ms": nccl / 1e3, "device_ms": device / 1e3, "nccl_kernels": calls}


def _mc_spatial(mesh, rank, world):
    """(c) `spatial_sharded_ondemand_corr` on this rank's 16-row slab (fp32
    and bf16), the slabs gathered, a seeded cotangent of the whole taken
    back: the gathered forward, the fmap1 and level gradients (digests),
    and the launches from the forward to the end of the backward."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.parallel.spatial import (
        all_gather_rows,
        spatial_sharded_ondemand_corr,
    )

    h, w = MC_SPATIAL_HW
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        f1, levels = ondemand_inputs(1, h, w, dt, seed=320)
        f1 = f1.reshape(1, h, w, -1).requires_grad_(True)
        levels = [f.requires_grad_(True) for f in levels]
        coords = serving_coords(1, h, w, seed=321)
        g = torch.randn(1, h, w, 4 * 81, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(322)).to(dt)
        torch.cuda.synchronize()
        co.reset_launches()
        slab = spatial_sharded_ondemand_corr(f1, levels, coords, 4, mesh, out_dtype=dt)
        whole = all_gather_rows(slab, mesh)
        (whole.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        res = {"launches": dict(co.LAUNCHES), "slab_rows": slab.shape[1],
               "digest": _digest([whole, f1.grad] + [f.grad for f in levels])}
        if rank == 0:  # one K4, K5 and K6 call on the frame, on this card alone
            flat1 = f1.detach().reshape(1, h * w, -1).contiguous()
            fl = [f.detach() for f in levels]
            flatc = coords.reshape(1, h * w, 2).contiguous()
            gf = g.reshape(1, h * w, -1).contiguous()
            ref = co.corr_ondemand_fwd(flat1, fl, flatc, 4, dt).reshape(whole.shape)
            ref_df1 = co.corr_ondemand_bwd_df1(fl, flatc, gf, 4).to(dt).reshape(f1.shape)
            ref_df2 = co.corr_ondemand_bwd_df2(flat1, flatc, gf, [tuple(f.shape[1:3]) for f in fl],
                                               4)
            res["forward_equal"] = bool(torch.equal(whole, ref))
            res["df1_equal"] = bool(torch.equal(f1.grad, ref_df1))
            res["df2"] = []
            for lvl, (got, r32) in enumerate(zip([f.grad for f in levels], ref_df2)):
                scale = float(r32.abs().max())
                d = (got.float() - r32).abs()
                if dt == torch.float32:  # the K6 gate
                    ok = bool(d.max() <= 2e-5 * scale)
                else:  # a bf16 gradient: one bf16 step of the fp32 sums + 2e-5 * max|ref|
                    ok = bool((d <= bf16_step(r32) + 2e-5 * scale).all())
                res["df2"].append({"level": lvl, "max_rel": float(d.max()) / max(scale, 1e-30),
                                   "off_round": int((got != r32.to(dt)).sum()), "ok": ok})
        out[str(dt)] = res
        del f1, levels, slab, whole
        torch.cuda.empty_cache()
    return out


def _worker_multicard(world, rank, port):
    """Rank `rank` of `world` NCCL processes, one card each (LOCAL_RANK):
    (a) the chairs step at global batch MC_BATCH on a 1-D 'data' mesh, then
    MC_TIMED steps for their ms; (b) the same step at global batch
    2 * (world // 2) on the ('data', 'space') mesh (world // 2, 2); (c) the
    spatial correlation on world 'space' ranks. Process 0 then takes (a)
    and (b) alone on its card while the others wait in the next collective:
    one more step of (a), which process 0 takes under the profiler (after
    its one-card timings, which the profiler would slow)."""
    from raft_optical_flow_tpu_torch.parallel import distributed
    from raft_optical_flow_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from raft_optical_flow_tpu_torch.train.trainer import RAFTTrainer

    if not distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cuda"):
        raise AssertionError("multicard: no process group")
    device = torch.device("cuda", torch.cuda.current_device())
    out = {"device": str(device), "backend": torch.distributed.get_backend()}
    with deterministic(False):
        stage, cfg = _parallel_stage(MC_BATCH)
        mesh = make_mesh()
        batch = _train_batch(MC_BATCH, seed=331)
        trainer_a = RAFTTrainer(stage, cfg, mesh=mesh)
        out["a"] = _mc_step(trainer_a, shard_batch(batch, mesh), MC_TIMED, full=rank == 0)
        nb = 2 * (world // 2)
        if world % 2 == 0:
            stage_b, _ = _parallel_stage(nb)
            mesh_b = make_mesh(axis_names=("data", "space"), shape=(world // 2, 2))
            batch_b = _train_batch(nb, seed=332)
            trainer = RAFTTrainer(stage_b, cfg, mesh=mesh_b)
            out["b"] = _mc_step(trainer, shard_batch(batch_b, mesh_b), 0, full=rank == 0)
            out["b"]["coords"] = (mesh_b.coord("data"), mesh_b.coord("space"))
            del trainer
        torch.cuda.empty_cache()
        out["c"] = _mc_spatial(make_mesh(axis_names=("space",)), rank, world)
        if rank == 0:  # the references on this card alone, no group
            torch.cuda.empty_cache()
            ref = RAFTTrainer(stage, cfg, device=device)
            out["ref_a"] = _mc_step(ref, batch, MC_TIMED)
            del ref
            if world % 2 == 0:
                ref = RAFTTrainer(stage_b, cfg, device=device)
                out["ref_b"] = _mc_step(ref, batch_b, 0)
                del ref
            torch.cuda.empty_cache()
            out["a"]["profile"] = _nccl_profile(trainer_a, shard_batch(batch, mesh))
        else:
            trainer_a.train_step(shard_batch(batch, mesh))  # the profiled step's collectives
    distributed.barrier(torch.distributed.group.WORLD)
    return out


def _mc_gates(tag, r0, rest, ref):
    """Phase parallel (b)'s gates: ranks bit for bit equal and generators
    equal, metrics within rel 1e-5 + abs 1e-6 of the one-card step,
    parameters max |d| < 1e-3 with under 1% over 1e-6, BatchNorm running
    statistics within 1e-5, 48 K1 and 48 K3 launches a step."""
    m0, mr = r0["metrics"], ref["metrics"]
    ranks_equal = all(r["digest"] == r0["digest"] and r["metrics"] == m0
                      and torch.equal(r["generator"], r0["generator"]) for r in rest)
    gen_equal = bool(torch.equal(r0["generator"], ref["generator"]))
    rel = {k: abs(m0[k] - mr[k]) / max(abs(mr[k]), 1e-30) for k in mr}
    close = all(abs(m0[k] - mr[k]) <= 1e-5 * abs(mr[k]) + 1e-6 for k in mr)
    d = torch.cat([(r0["params"][k].double() - ref["params"][k].double()).abs().flatten()
                   for k in ref["params"]])
    frac = float((d > 1e-6).double().mean())
    bn = [k for k in ref["buffers"] if "running" in k]
    bn_d = max(float((r0["buffers"][k].double() - ref["buffers"][k].double()).abs().max())
               for k in bn)
    expect = {"corr_lookup_level": 4 * TRAIN_ITERS, "corr_lookup_level_bwd": 4 * TRAIN_ITERS}
    for r in [r0] + rest:
        expect_launches(r["launches"], expect, f"multicard {tag} step")
    res = {"ranks_equal": ranks_equal, "generator_equal": gen_equal, "metrics_rel": rel,
           "params_max_abs": float(d.max()), "params_frac_over_1e-6": frac,
           "bn_max_abs": bn_d, "bn_tensors": len(bn), "launches": r0["launches"]}
    if not (ranks_equal and gen_equal and close and res["params_max_abs"] < 1e-3
            and frac < 0.01 and bn_d <= 1e-5):
        raise AssertionError(f"multicard {tag}: the cards' step is not the one-card step: {res}")
    return res


def _mc_cards(n):
    """(a)-(c) from one run of n worker processes."""
    outs = _run_workers("multicard", list(range(n)), n, timeout=MC_WORKER_TIMEOUT_S,
                        env_of=lambda r: {"LOCAL_RANK": str(r)})
    r0, rest = outs[0], outs[1:]
    devices = [o["device"] for o in outs]
    if devices != [f"cuda:{i}" for i in range(n)] or {o["backend"] for o in outs} != {"nccl"}:
        raise AssertionError(f"multicard: ranks on {devices}, backends "
                             f"{[o['backend'] for o in outs]}")
    res = {"a": _mc_gates("(a)", r0["a"], [o["a"] for o in rest], r0["ref_a"])}
    a, ra, prof = r0["a"], r0["ref_a"], r0["a"]["profile"]
    ms_n, ms_1 = float(np.median(a["ms"])), float(np.median(ra["ms"]))
    res["a"].update({
        "ms_cards": a["ms"], "ms_one_card": ra["ms"], "median_ms_cards": ms_n,
        "median_ms_one_card": ms_1, "pairs_per_s_cards": MC_BATCH * 1e3 / ms_n,
        "pairs_per_s_one_card": MC_BATCH * 1e3 / ms_1, "scaling": ms_1 / ms_n,
        "ms_rank_medians": [float(np.median(o["a"]["ms"])) for o in outs], **prof,
        "nccl_share_of_device": prof["nccl_ms"] / max(prof["device_ms"], 1e-9)})
    log(f"multicard (a) the chairs step (RAFT-standard fp32, BN training, {TRAIN_HW[0]}x"
        f"{TRAIN_HW[1]}, {TRAIN_ITERS} iterations, cudnn.deterministic) at global batch "
        f"{MC_BATCH}: {n} NCCL processes on {devices}, {MC_BATCH // n} rows each, against one "
        f"process at {MC_BATCH} on cuda:0: {json.dumps(res['a'])}")
    if "b" in r0:
        res["b"] = _mc_gates("(b)", r0["b"], [o["b"] for o in rest], r0["ref_b"])
        res["b"]["coords"] = [o["b"]["coords"] for o in outs]
        log(f"multicard (b) the ('data', 'space') = ({n // 2}, 2) mesh, the step at global batch "
            f"{2 * (n // 2)} over 'data' against one process: {json.dumps(res['b'])}")
    else:
        log(f"multicard (b): {n} cards do not make a ('data', 'space') mesh of 'space' 2, not run")
    c0 = r0["c"]
    for dt, v in c0.items():
        same = all(o["c"][dt]["digest"] == v["digest"] for o in rest)
        launches = [o["c"][dt]["launches"] for o in outs]
        one = {"corr_ondemand_fwd": 1, "corr_ondemand_bwd_df1": 1, "corr_ondemand_bwd_df2": 1,
               "corr_ondemand_df2_plan": 1}
        ok = (same and v["forward_equal"] and v["df1_equal"] and all(x["ok"] for x in v["df2"])
              and all(x == one for x in launches)
              and v["slab_rows"] == MC_SPATIAL_HW[0] // n)
        log(f"multicard (c) spatial on {n} 'space' ranks, {dt}, fmap {MC_SPATIAL_HW[0]}x"
            f"{MC_SPATIAL_HW[1]} (C=256, 4 levels, radius 4), {v['slab_rows']}-row slabs, "
            f"against one K4/K5/K6 call on the frame: ranks equal {same}, forward equal "
            f"{v['forward_equal']}, df1 equal {v['df1_equal']}, df2 {v['df2']}, launches per "
            f"rank {launches}")
        if not ok:
            raise AssertionError(f"multicard (c) {dt}: {v}, ranks equal {same}, {launches}")
    res["c"] = {dt: {k: v[k] for k in ("forward_equal", "df1_equal", "df2", "launches")}
                for dt, v in c0.items()}
    return res


def _mc_cli(n, workdir):
    """(d) `cli/train_raft.py --stage chairs --batch_size 8 --num_steps 3` on
    phase data_eval's chairs tree: with no --dist_* flag (the launcher: n
    processes, each logging its cuda:i), with explicit --dist_* flags over
    n processes, and under CUDA_VISIBLE_DEVICES=0, all at once; each writes
    its weights after every step (`--val_freq 1`, no validation). The
    first two's files are equal bit for bit. The one-card run's step-1
    weights are held to (a)'s one-step gate, as tests/test_torch_parallel_
    cli.py holds its runs; its step-3 weights to max |d| < 1e-3 (AdamW's
    normalized updates carry the reduction order's rounding further each
    step, past 1e-6 on more than 1% of the weights by step 3)."""
    roots, _, _ = _write_trees(os.path.join(workdir, "trees"), datasets=("chairs",))
    site = os.path.join(workdir, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(MC_SITECUSTOMIZE)
    base = [sys.executable, "-m", "raft_optical_flow_tpu_torch.cli.train_raft", "--stage",
            "chairs", "--batch_size", str(MC_BATCH), "--num_steps", "3", "--data_root",
            roots["chairs"], "--image_size", *map(str, CHAIRS_CROP), "--val_freq", "1"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([site, REPO]))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    runs = {"launched": [(base, env)], "single": [(base, dict(env, CUDA_VISIBLE_DEVICES="0"))],
            "explicit": [(base + ["--dist_coordinator", f"127.0.0.1:{port}",
                                  "--dist_num_processes", str(n), "--dist_process_id", str(i)],
                          env) for i in range(n)]}
    procs = {}
    t0 = time.perf_counter()
    for name, cmds in runs.items():
        ck = os.path.join(workdir, name)
        procs[name] = [subprocess.Popen(cmd + ["--checkpoint_dir", ck], env=e, cwd=REPO,
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True) for cmd, e in cmds]
    logs, secs = {}, {}
    try:
        for name, ps in procs.items():
            logs[name] = []
            for p in ps:
                text, _ = p.communicate(timeout=max(MC_WORKER_TIMEOUT_S - (time.perf_counter()
                                                                            - t0), 1.0))
                logs[name].append(text)
                if p.returncode != 0:
                    raise AssertionError(f"multicard (d) {name} exited {p.returncode}:\n"
                                         f"{text[-4000:]}")
            secs[name] = time.perf_counter() - t0
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    said = logs["launched"][0]
    devices = [f"cuda:{i}" for i in range(n)]
    logged = [any(line.endswith(f"process {i} of {n} on {d}") for line in said.splitlines())
              for i, d in enumerate(devices)]

    def weights(name, f):
        with np.load(os.path.join(workdir, name, f"{f}.npz")) as z:
            return {k: z[k] for k in z.files}

    files = ["raft_1", "raft_2", "raft_3", "raft"]
    equal = True
    for f in files:
        wl, we = weights("launched", f), weights("explicit", f)
        equal = equal and wl.keys() == we.keys() and all(np.array_equal(wl[k], we[k]) for k in wl)
    res = {"processes_logged": logged, "launched_equals_explicit": equal,
           "files": sorted(os.listdir(os.path.join(workdir, "launched"))),
           "seconds_at_end": secs}
    for f in ("raft_1", "raft_3"):
        wl, ws = weights("launched", f), weights("single", f)
        d = np.concatenate([np.abs(wl[k].astype(np.float64) - ws[k]).ravel() for k in sorted(ws)])
        res[f"{f}_vs_one_card_max_abs"] = float(d.max())
        res[f"{f}_vs_one_card_frac_over_1e-6"] = float((d > 1e-6).mean())
    res["batch_stats_in_file"] = any("batch_stats" in k for k in wl)
    log(f"multicard (d) cli/train_raft --stage chairs --batch_size {MC_BATCH} --num_steps 3 on "
        f"the chairs tree (cudnn.deterministic in each process): no --dist_* flag against "
        f"explicit --dist_* over {n} processes and CUDA_VISIBLE_DEVICES=0: {json.dumps(res)}")
    if not (all(logged) and equal and res["raft_1_vs_one_card_max_abs"] < 1e-3
            and res["raft_1_vs_one_card_frac_over_1e-6"] < 0.01
            and res["raft_3_vs_one_card_max_abs"] < 1e-3 and res["batch_stats_in_file"]):
        raise AssertionError(f"multicard (d): {res}\n{said[-3000:]}")
    return res


def phase_multicard(state):
    import shutil

    n = torch.cuda.device_count()
    if n < 2:
        if state.get("multicard_asked"):
            raise AssertionError(f"phase multicard needs two or more cards; {n} visible")
        log(f"multicard: {n} card visible, not run")
        return
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(f"multicard: {n} cards: {smi.stdout.strip().splitlines()}")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    shutil.rmtree(MULTICARD_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    os.makedirs(MULTICARD_DIR)
    try:
        res = _mc_cards(n)
        res["d"] = _mc_cli(n, MULTICARD_DIR)
    finally:
        shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
        shutil.rmtree(MULTICARD_DIR, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    state["multicard"] = res
    if res["seconds"] > MC_PHASE_LIMIT_S:
        raise AssertionError(f"phase multicard took {res['seconds']:.1f} s (limit "
                             f"{MC_PHASE_LIMIT_S} s)")
    log(f"phase multicard: ok in {res['seconds']:.1f} s")


def _bytes_needed(levels, coords_flat, radius, out_itemsize):
    """Bytes the lookup must move for these inputs: each query's in-bounds
    (K+1)^2 patch of each level, its coords, and its K^2 outputs per level."""
    K = 2 * radius + 1
    total = coords_flat.shape[0] * coords_flat.shape[1] * 8
    for lvl, c in levels:
        Hl, Wl = c.shape[2:]
        s = 1.0 / 2**lvl
        x0 = torch.floor(coords_flat[..., 0] * s) - radius
        y0 = torch.floor(coords_flat[..., 1] * s) - radius
        nx = (torch.clamp(x0 + K, max=Wl - 1) - torch.clamp(x0, min=0) + 1).clamp(min=0)
        ny = (torch.clamp(y0 + K, max=Hl - 1) - torch.clamp(y0, min=0) + 1).clamp(min=0)
        total += float((nx * ny).sum()) * c.element_size()
        total += coords_flat.shape[0] * coords_flat.shape[1] * K * K * out_itemsize
    return total


def _sector_bytes(levels, coords_flat, radius, out_itemsize, granule=32):
    """_bytes_needed with each patch row counted in the `granule`-byte units
    (32: sectors) it touches in its level's buffer (which starts on such a
    unit): the least DRAM traffic of a gather that reads each row once, if
    memory moves whole units. Coords and outputs are contiguous, counted as
    bytes."""
    K = 2 * radius + 1
    n = coords_flat.shape[0] * coords_flat.shape[1]
    q = torch.arange(n, device=coords_flat.device, dtype=torch.int64)
    total = n * 8
    for lvl, c in levels:
        Hl, Wl = c.shape[2:]
        total += n * K * K * out_itemsize
        if Hl == 0 or Wl == 0:
            continue
        es, s = c.element_size(), 1.0 / 2**lvl
        x0 = torch.floor(coords_flat[..., 0].reshape(-1) * s) - radius
        y0 = torch.floor(coords_flat[..., 1].reshape(-1) * s) - radius
        xa = x0.clamp(0, Wl - 1).long()
        xb = (x0 + K).clamp(0, Wl - 1).long()
        cols_in = (x0 + K >= 0) & (x0 <= Wl - 1)
        for j in range(K + 1):
            y = y0 + j
            ok = cols_in & (y >= 0) & (y <= Hl - 1)
            base = (q * Hl + y.clamp(0, Hl - 1).long()) * Wl
            first = (base + xa) * es // granule
            last = ((base + xb) * es + es - 1) // granule
            total += float(torch.where(ok, last - first + 1, 0).sum()) * granule
    return total


def _grid_sample_fn(c, coords_flat, lvl, radius):
    """F.grid_sample over the volume as [B*Q, 1, Hl, Wl] with a [B*Q, K, K, 2]
    grid, align_corners=True, zero padding: the reference CorrBlock's call."""
    B, Q, Hl, Wl = c.shape
    from raft_optical_flow_tpu_torch.ops.corr import window_offsets

    ox, oy = window_offsets(radius, c.device)
    K = 2 * radius + 1
    px = coords_flat[..., 0:1] / 2**lvl + ox
    py = coords_flat[..., 1:2] / 2**lvl + oy
    grid = torch.stack([2 * px / (Wl - 1) - 1, 2 * py / (Hl - 1) - 1], dim=-1)
    grid = grid.reshape(B * Q, K, K, 2).to(c.dtype)
    vol = c.reshape(B * Q, 1, Hl, Wl)
    return lambda: F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)


def phase_timing(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf

    B, radius, dt = 16, 4, torch.bfloat16
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    pyr = serving_pyramid(B, h, w, dt, seed=21)
    coords = serving_coords(B, h, w, seed=22)
    flat = coords.reshape(B, h * w, 2).contiguous()
    saved = dict(ck.LAUNCHES)
    saved_ondemand = dict(co.LAUNCHES)
    saved_gru = dict(gf.LAUNCHES)
    rows = {}

    k1 = lambda: ck.corr_lookup_level(pyr[0], flat, radius, dt)
    k1_plain = lambda: ck.corr_lookup_level_plain(pyr[0], flat, radius, dt)
    k2 = lambda: ck.corr_lookup_coarse_fused(pyr[1:], flat, radius, dt)
    k2_plain = lambda: ck.corr_lookup_coarse_fused_plain(pyr[1:], flat, radius, dt)
    gs0 = _grid_sample_fn(pyr[0], flat, 0, radius)
    gs_coarse = [_grid_sample_fn(c, flat, lvl, radius) for lvl, c in enumerate(pyr) if lvl]

    def gs2():
        for f in gs_coarse:
            f()

    smooth = smooth_coords(B, h, w, seed=23).reshape(B, h * w, 2).contiguous()
    for name, fn, plain_fn, lib_fn, levels in (
        ("corr_lookup_level", k1, k1_plain, gs0, [(0, pyr[0])]),
        ("corr_lookup_coarse_fused", k2, k2_plain, gs2, list(enumerate(pyr))[1:]),
    ):
        _check_equal(f"{name} timed inputs", fn(), plain_fn())
        # plain, kernel, kernel, plain: two readings each within one call
        p1 = cuda_ms(plain_fn, 3)
        k_a = cuda_ms(fn, 20)
        k_b = cuda_ms(fn, 20)
        p2 = cuda_ms(plain_fn, 3)
        lib = cuda_ms(lib_fn, 10)
        nbytes = _bytes_needed(levels, flat, radius, 2)
        sectors = _sector_bytes(levels, flat, radius, 2)
        units64 = _sector_bytes(levels, flat, radius, 2, granule=64)
        K = 2 * radius + 1
        n_out = B * h * w * K * K * len(levels)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = n_out * 17 / FP32_FLOPS_PER_S * 1e3  # 17 fp32 ops per output
        rows[name] = {
            "ms": min(k_a, k_b), "ms_readings": [k_a, k_b],
            "plain_ms": min(p1, p2), "plain_readings": [p1, p2],
            "library_ms": lib, "bytes": nbytes, "sector_bytes": sectors,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "sector_floor_ms": sectors / HBM_BYTES_PER_S * 1e3,
        }
        r = rows[name]
        log(f"timing {name}: B={B} r={radius} bf16 kernel {k_a:.4f}/{k_b:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, grid_sample {lib:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes / 1e6:.2f} MB; in 32-byte sectors {sectors / 1e6:.2f} "
            f"MB, {r['sector_floor_ms']:.4f} ms; in 64-byte units {units64 / 1e6:.2f} MB, "
            f"{units64 / r['ms'] / 1e9:.3f} TB/s at the kernel's time)")
    # the same on a smooth field (RAFT's flow), each held against its plain version
    k1s = lambda: ck.corr_lookup_level(pyr[0], smooth, radius, dt)
    k2s = lambda: ck.corr_lookup_coarse_fused(pyr[1:], smooth, radius, dt)
    _check_equal("corr_lookup_level smooth field", k1s(),
                 ck.corr_lookup_level_plain(pyr[0], smooth, radius, dt))
    _check_equal("corr_lookup_coarse_fused smooth field", k2s(),
                 ck.corr_lookup_coarse_fused_plain(pyr[1:], smooth, radius, dt))
    for name, fn, levels in (("corr_lookup_level", k1s, [(0, pyr[0])]),
                             ("corr_lookup_coarse_fused", k2s, list(enumerate(pyr))[1:])):
        rows[name]["ms_smooth"] = cuda_ms(fn, 20)
        rows[name]["sector_bytes_smooth"] = _sector_bytes(levels, smooth, radius, 2)
        log(f"timing {name} smooth field: kernel {rows[name]['ms_smooth']:.4f} ms "
            f"({rows[name]['sector_bytes_smooth'] / 1e6:.2f} MB in sectors)")
    # K8: every level in one launch, fp32 out; yardstick the four grid_samples
    k8 = lambda: ck.corr_pyramid_lookup_cuda_fused(pyr, coords, radius)
    k8_plain = lambda: ck.corr_pyramid_lookup_fused_plain(pyr, coords, radius)
    if not torch.equal(k8(), k8_plain()):
        raise AssertionError("K8 differs from its plain version on the timed inputs")

    def gs_all():
        gs0()
        gs2()

    K = 2 * radius + 1
    rows["corr_lookup_all_levels"] = _timing_row(
        "corr_lookup_all_levels", k8, k8_plain, gs_all,
        _bytes_needed(list(enumerate(pyr)), flat, radius, 4), B * h * w * K * K * len(pyr) * 17,
        torch.float32, f"B={B} r={radius} bf16 volume, fp32 windows, levels 55x128..6x16;")
    k8_sectors = _sector_bytes(list(enumerate(pyr)), flat, radius, 4)
    k8_units64 = _sector_bytes(list(enumerate(pyr)), flat, radius, 4, granule=64)
    rows["corr_lookup_all_levels"].update(sector_bytes=k8_sectors,
                                          sector_floor_ms=k8_sectors / HBM_BYTES_PER_S * 1e3)
    log(f"timing corr_lookup_all_levels: {k8_sectors / 1e6:.2f} MB in 32-byte sectors, "
        f"{k8_sectors / HBM_BYTES_PER_S * 1e3:.4f} ms; in 64-byte units {k8_units64 / 1e6:.2f} "
        f"MB, {k8_units64 / rows['corr_lookup_all_levels']['ms'] / 1e9:.3f} TB/s at the "
        f"kernel's time")
    del pyr
    rows["corr_lookup_level_bwd"] = _time_k3(radius, dt)
    _time_ondemand(rows)
    _time_ondemand_fp32(rows)
    rows["sepconv_gru_pass"] = _time_k7()
    ck.LAUNCHES.update(saved)  # timing launches are not the main path's
    co.LAUNCHES.update(saved_ondemand)
    gf.LAUNCHES.update(saved_gru)
    state["timing"] = rows
    log("phase timing: ok")


def _ondemand_taps(levels, coords, radius):
    """In-bounds (2r+2)^2 taps over every query and level of these coords:
    each is one C-long multiply-add the kernels must do."""
    n_taps = 2 * radius + 2
    total = 0.0
    for lvl, f in enumerate(levels):
        Hl, Wl = f.shape[1:3]
        x0 = torch.floor(coords[..., 0] / 2**lvl) - radius
        y0 = torch.floor(coords[..., 1] / 2**lvl) - radius
        nx = (torch.clamp(x0 + n_taps - 1, max=Wl - 1) - torch.clamp(x0, min=0) + 1).clamp(min=0)
        ny = (torch.clamp(y0 + n_taps - 1, max=Hl - 1) - torch.clamp(y0, min=0) + 1).clamp(min=0)
        total += float((nx * ny).sum())
    return total


def _ondemand_library(f1, levels, coords, radius):
    """The library formulation: F.grid_sample of each fmap2 level (NCHW, in
    its dtype) at the window points, align_corners=True, zero padding, then
    the dot with fmap1 and the 1/sqrt(C) scale. Returns (forward, leaves)."""
    from raft_optical_flow_tpu_torch.ops.corr import window_offsets

    B, Q, C = f1.shape
    K = 2 * radius + 1
    ox, oy = window_offsets(radius, "cuda")
    f1 = f1.detach().requires_grad_()
    imgs, grids = [], []
    for lvl, f in enumerate(levels):
        Hl, Wl = f.shape[1:3]
        px = coords[..., 0:1] / 2**lvl + ox
        py = coords[..., 1:2] / 2**lvl + oy
        grid = torch.stack([2 * px / (Wl - 1) - 1, 2 * py / (Hl - 1) - 1], dim=-1)
        grids.append(grid.reshape(B, Q, K * K, 2).to(f.dtype))
        imgs.append(f.permute(0, 3, 1, 2).contiguous().requires_grad_())

    def forward():
        outs = [torch.einsum("bcqk,bqc->bqk", F.grid_sample(
            img, grid, mode="bilinear", padding_mode="zeros", align_corners=True), f1)
            for img, grid in zip(imgs, grids)]
        return torch.cat(outs, dim=-1) * C**-0.5

    return forward, f1, imgs


def _timing_row(name, fn, plain_fn, lib_fn, nbytes, n_ops, dtype, detail, rate=None):
    """plain, kernel, kernel, plain (two readings each, in one call), the
    library yardstick, and the bound (operations at `rate`, else at the
    dtype's peak)."""
    p1 = cuda_ms(plain_fn, 3)
    k_a = cuda_ms(fn, 20)
    k_b = cuda_ms(fn, 20)
    p2 = cuda_ms(plain_fn, 3)
    lib = cuda_ms(lib_fn, 5)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_ops / (rate or FLOPS_PER_S[dtype]) * 1e3
    row = {
        "ms": min(k_a, k_b), "ms_readings": [k_a, k_b],
        "plain_ms": min(p1, p2), "plain_readings": [p1, p2],
        "library_ms": lib, "bytes": nbytes, "ops": n_ops,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "fp32_core_floor_ms": n_ops / FP32_FLOPS_PER_S * 1e3,
    }
    log(f"timing {name}: {detail} kernel {k_a:.4f}/{k_b:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
        f"library {lib:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{nbytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP; at the fp32 CUDA-core rate "
        f"{row['fp32_core_floor_ms']:.4f} ms)")
    return row


def _time_ondemand(rows):
    """K4 at the batch-16 serving shape, K5 and K6 (and K6's prepass) at the
    batch-4 training shape, bf16 operands and cotangents, r = 4, C = 256;
    each first held against its plain version on the very inputs it is
    timed on. K4 and K6 are timed again on a smooth field (ms_smooth), and
    K4's rows carry the routes its tiles took on both inputs."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    dt, radius = torch.bfloat16, 4
    K2 = (2 * radius + 1) ** 2
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    B, C = 16, 256
    f1, levels = ondemand_inputs(B, h, w, dt, seed=25)
    coords = serving_coords(B, h, w, seed=26).reshape(B, h * w, 2).contiguous()
    smooth = smooth_coords(B, h, w, seed=30).reshape(B, h * w, 2).contiguous()
    fn = lambda: co.corr_ondemand_fwd(f1, levels, coords, radius, dt)
    plain_fn = lambda: co.corr_ondemand_fwd_plain(f1, levels, coords, radius, dt)
    check_k4("K4 timed inputs", fn(), co.corr_ondemand_fwd_plain(f1, levels, coords, radius))
    routes = co.corr_ondemand_fwd_routes()
    smooth_fn = lambda: co.corr_ondemand_fwd(f1, levels, smooth, radius, dt)
    check_k4("K4 smooth inputs", smooth_fn(),
             co.corr_ondemand_fwd_plain(f1, levels, smooth, radius))
    routes_smooth = co.corr_ondemand_fwd_routes()
    lib_fwd, *_ = _ondemand_library(f1, levels, coords, radius)
    lib_fn = lambda: lib_fwd().detach()
    Q = h * w
    taps = _ondemand_taps(levels, coords, radius)
    nbytes = (f1.numel() * 2 + sum(f.numel() for f in levels) * 2 + B * Q * 8
              + B * Q * len(levels) * K2 * 2)
    n_ops = taps * C * 2 + B * Q * len(levels) * K2 * 9  # the dots, then 9 ops per window value
    row = _timing_row(
        "corr_ondemand_fwd", fn, plain_fn, lib_fn, nbytes, n_ops, dt,
        f"B={B} Q={Q} C={C} r={radius} bf16 levels 55x128..6x16, {taps:.0f} in-bounds taps;")
    row.update(ms_smooth=cuda_ms(smooth_fn, 20), routes=routes, routes_smooth=routes_smooth)
    rows["corr_ondemand_fwd"] = row
    log(f"timing corr_ondemand_fwd on a smooth field: {row['ms_smooth']:.4f} ms; routes of its "
        f"tiles (tile, level): timed inputs {routes}, smooth field {routes_smooth}")
    del f1, levels, coords, smooth, lib_fwd
    torch.cuda.empty_cache()

    B = 4
    h, w = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    Q = h * w
    f1, levels = ondemand_inputs(B, h, w, dt, seed=27)
    coords = serving_coords(B, h, w, seed=28).reshape(B, Q, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(29)
    g = torch.randn(B, Q, len(levels) * K2, device="cuda", generator=gen).to(dt)
    smooth = smooth_coords(B, h, w, seed=32).reshape(B, Q, 2).contiguous()
    shapes = [tuple(f.shape[1:3]) for f in levels]
    check_rel("K5 timed inputs", co.corr_ondemand_bwd_df1(levels, coords, g, radius),
              co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius))
    n_pairs = {}
    for tag, c in (("timed", coords), ("smooth", smooth)):
        n_pairs[tag] = check_plan(f"{tag} inputs", c, shapes, radius)
        for lvl, (a, b) in enumerate(zip(co.corr_ondemand_bwd_df2(f1, c, g, shapes, radius),
                                         co.corr_ondemand_bwd_df2_plain(f1, c, g, shapes,
                                                                        radius))):
            check_rel(f"K6 {tag} inputs l{lvl}", a, b)
    lib_fwd, f1_leaf, img_leaves = _ondemand_library(f1, levels, coords, radius)
    out = lib_fwd()
    taps = _ondemand_taps(levels, coords, radius)
    n_ops = taps * C * 2 + taps * 6  # the dots, and each tap's cotangent
    common = B * Q * 8 + g.numel() * 2
    detail = f"B={B} Q={Q} C={C} r={radius} bf16 levels 46x62..5x7, {taps:.0f} in-bounds taps;"
    row = _timing_row(
        "corr_ondemand_bwd_df1", lambda: co.corr_ondemand_bwd_df1(levels, coords, g, radius),
        lambda: co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius),
        lambda: torch.autograd.grad(out, [f1_leaf], g, retain_graph=True),
        common + sum(f.numel() for f in levels) * 2 + B * Q * C * 4, n_ops, dt, detail)
    check_rel("K5 smooth inputs", co.corr_ondemand_bwd_df1(levels, smooth, g, radius),
              co.corr_ondemand_bwd_df1_plain(levels, smooth, g, radius))
    row["ms_smooth"] = cuda_ms(lambda: co.corr_ondemand_bwd_df1(levels, smooth, g, radius), 20)
    rows["corr_ondemand_bwd_df1"] = row
    log(f"timing corr_ondemand_bwd_df1 on a smooth field: {row['ms_smooth']:.4f} ms")
    row = _timing_row(
        "corr_ondemand_bwd_df2 (the wrapper: prepass and K6)",
        lambda: co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius),
        lambda: co.corr_ondemand_bwd_df2_plain(f1, coords, g, shapes, radius),
        lambda: torch.autograd.grad(out, img_leaves, g, retain_graph=True),
        common + f1.numel() * 2 + sum(f.numel() for f in levels) * 4, n_ops, dt, detail)
    row["ms_smooth"] = cuda_ms(lambda: co.corr_ondemand_bwd_df2(f1, smooth, g, shapes, radius), 20)
    # as CUDA-graph replays too: the device's time without the wrappers' host time
    row["graph_ms"] = graph_ms(lambda: co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius), 10)
    rows["corr_ondemand_bwd_df2"] = row
    log(f"timing corr_ondemand_bwd_df2 on a smooth field: {row['ms_smooth']:.4f} ms; as CUDA-graph "
        f"replays (timed inputs): {row['graph_ms']:.4f} ms")
    del out
    # K6's prepass alone: bytes are coords read once, the (query, row) pairs
    # (16 bytes each) and the row starts written once; about 20 fp32
    # operations per query and level (two passes of the taps); library
    # yardstick: one torch.sort of the pairs' (row, query) keys
    _, starts = co.corr_ondemand_df2_plan(coords, shapes, radius)
    nt = 2 * radius + 2
    keys = []
    for lvl, (hl, wl) in enumerate(shapes):
        f = torch.floor(coords * 2.0**-lvl)
        tx = f[..., 0].clamp(-(radius + 2), wl + radius).long() - radius
        ys = (f[..., 1].clamp(-(radius + 2), hl + radius).long() - radius)[..., None] + \
            torch.arange(nt, device="cuda")
        ok = (ys >= 0) & (ys < hl) & ((tx + nt - 1 >= 0) & (tx < wl))[..., None]
        q = torch.arange(Q, device="cuda")[:, None]
        keys.append(torch.where(ok, ys * Q + q, hl * Q).reshape(B, -1))
    keys = torch.stack(keys, dim=1)
    rows["corr_ondemand_df2_plan"] = _timing_row(
        "corr_ondemand_df2_plan", lambda: co.corr_ondemand_df2_plan(coords, shapes, radius),
        lambda: co.corr_ondemand_df2_plan_plain(coords, shapes, radius),
        lambda: torch.sort(keys, dim=-1),
        B * Q * 8 + n_pairs["timed"] * 16 + starts.numel() * 4, 20 * B * Q * len(shapes),
        torch.float32, f"B={B} Q={Q} r={radius} levels 46x62..5x7, {n_pairs['timed']} (query, "
        f"row) pairs, library = torch.sort of the pairs' keys alone;")
    plan = rows["corr_ondemand_df2_plan"]
    plan["graph_ms"] = graph_ms(lambda: co.corr_ondemand_df2_plan(coords, shapes, radius), 10)
    log(f"timing corr_ondemand_df2_plan as CUDA-graph replays: {plan['graph_ms']:.4f} ms")


def _native_grid_sampler(fn):
    """fn with cuDNN off: PyTorch's own grid_sampler_2d kernels, as in bf16
    (cuDNN's fp32 grid sampler refuses the batch-16 call)."""
    def run():
        with torch.backends.cudnn.flags(enabled=False):
            return fn()
    return run


def _time_ondemand_fp32(rows):
    """The fp32 routes (fp32 operands, fp32 windows and cotangents, r = 4, C
    = 256): K4 at the batch-16 serving shape (the `fp32_*` keys of its row)
    and at batch 1 (`fp32_b1_*`, one Sintel pair of `evaluate
    --alternate_corr`), K5 at the chairs stage's shape (batch 10, 368x496 ->
    46x62); each on the serving coords and on a smooth field, each first
    held against its plain version on the very inputs it is timed on. The
    yardstick is `_ondemand_library` in fp32 with TF32 off (autograd of it
    for fmap1 alone for K5), on PyTorch's own grid sampler; the bound takes the tap dots at the fastest
    fp32-accurate rate (FP32_ACCURATE_FLOPS_PER_S)."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co
    from raft_optical_flow_tpu_torch.kernels.gru_fused import _full_fp32

    fp32, radius, C = torch.float32, 4, 256
    K2 = (2 * radius + 1) ** 2
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    Q = h * w
    row = rows["corr_ondemand_fwd"]
    for B, key, seed in ((16, "fp32", 35), (1, "fp32_b1", 37)):
        f1, levels = ondemand_inputs(B, h, w, fp32, seed=seed)
        coords = serving_coords(B, h, w, seed=seed + 1).reshape(B, Q, 2).contiguous()
        smooth = smooth_coords(B, h, w, seed=seed + 2).reshape(B, Q, 2).contiguous()
        fn = lambda: co.corr_ondemand_fwd(f1, levels, coords, radius, fp32)
        plain_fn = lambda: co.corr_ondemand_fwd_plain(f1, levels, coords, radius, fp32)
        check_k4(f"K4 {key} timed inputs", fn(), plain_fn())
        routes = co.corr_ondemand_fwd_routes()
        smooth_fn = lambda: co.corr_ondemand_fwd(f1, levels, smooth, radius, fp32)
        check_k4(f"K4 {key} smooth inputs", smooth_fn(),
                 co.corr_ondemand_fwd_plain(f1, levels, smooth, radius, fp32))
        routes_smooth = co.corr_ondemand_fwd_routes()
        lib_fwd, *_ = _ondemand_library(f1, levels, coords, radius)
        lib_fn = _native_grid_sampler(lambda: lib_fwd().detach())
        taps = _ondemand_taps(levels, coords, radius)
        nbytes = (f1.numel() * 4 + sum(f.numel() for f in levels) * 4 + B * Q * 8
                  + B * Q * len(levels) * K2 * 4)
        with _full_fp32():
            r = _timing_row(
                f"corr_ondemand_fwd {key}", fn, plain_fn, lib_fn, nbytes,
                taps * C * 2 + B * Q * len(levels) * K2 * 9, fp32,
                f"B={B} Q={Q} C={C} r={radius} fp32 levels 55x128..6x16, {taps:.0f} in-bounds "
                f"taps, library in fp32 with TF32 off;", rate=FP32_ACCURATE_FLOPS_PER_S)
        r_smooth = cuda_ms(smooth_fn, 20)
        row.update({f"{key}_{k}": r[k] for k in ("ms", "ms_readings", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by", "bytes", "ops",
                                                  "fp32_core_floor_ms")})
        row.update({f"{key}_ms_smooth": r_smooth, f"{key}_routes": routes,
                    f"{key}_routes_smooth": routes_smooth})
        log(f"timing corr_ondemand_fwd {key} on a smooth field: {r_smooth:.4f} ms; routes of "
            f"its tiles (tile, level): timed inputs {routes}, smooth field {routes_smooth}")
        del f1, levels, coords, smooth, lib_fwd
        torch.cuda.empty_cache()

    B = 10
    h, w = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    Q = h * w
    f1, levels = ondemand_inputs(B, h, w, fp32, seed=39)
    coords = serving_coords(B, h, w, seed=40).reshape(B, Q, 2).contiguous()
    smooth = smooth_coords(B, h, w, seed=41).reshape(B, Q, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(42)
    g = torch.randn(B, Q, len(levels) * K2, device="cuda", generator=gen)
    fn = lambda: co.corr_ondemand_bwd_df1(levels, coords, g, radius)
    plain_fn = lambda: co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius)
    check_rel("K5 fp32 timed inputs", fn(), plain_fn())
    smooth_fn = lambda: co.corr_ondemand_bwd_df1(levels, smooth, g, radius)
    check_rel("K5 fp32 smooth inputs", smooth_fn(),
              co.corr_ondemand_bwd_df1_plain(levels, smooth, g, radius))
    lib_fwd, f1_leaf, _ = _ondemand_library(f1, levels, coords, radius)
    taps = _ondemand_taps(levels, coords, radius)
    with _full_fp32(), torch.backends.cudnn.flags(enabled=False):
        out = lib_fwd()
    with _full_fp32():
        r = _timing_row(
            "corr_ondemand_bwd_df1 fp32", fn, plain_fn,
            _native_grid_sampler(lambda: torch.autograd.grad(out, [f1_leaf], g,
                                                             retain_graph=True)),
            B * Q * 8 + g.numel() * 4 + sum(f.numel() for f in levels) * 4 + B * Q * C * 4,
            taps * C * 2 + taps * 6, fp32,
            f"B={B} Q={Q} C={C} r={radius} fp32 levels 46x62..5x7, fp32 g, {taps:.0f} in-bounds "
            f"taps, library in fp32 with TF32 off;", rate=FP32_ACCURATE_FLOPS_PER_S)
    r_smooth = cuda_ms(smooth_fn, 20)
    rows["corr_ondemand_bwd_df1"].update(
        {f"fp32_{k}": r[k] for k in ("ms", "ms_readings", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by", "bytes", "ops", "fp32_core_floor_ms")})
    rows["corr_ondemand_bwd_df1"]["fp32_ms_smooth"] = r_smooth
    log(f"timing corr_ondemand_bwd_df1 fp32 on a smooth field: {r_smooth:.4f} ms")
    del f1, levels, coords, smooth, g, out, lib_fwd, f1_leaf
    torch.cuda.empty_cache()


def _time_k7():
    """K7 at the batch-16 bf16 serving shape (55x128, D = 128, X = 256): one
    GRU step's two launches (1x5, then 5x1), each first held against the plain
    version on its inputs. The row is per launch: the step's times over 2,
    against the unfused SepConvGRU (six cuDNN convs and their elementwise
    work) on the same NCHW inputs, also over 2. The model's per-step weight
    preparation (`pass_weights`) is outside the timed call. Then the fp32
    route pass by pass at the batch-2 training and batch-1 serving shapes."""
    from raft_optical_flow_tpu_torch.kernels import gru_fused as gf
    from raft_optical_flow_tpu_torch.models.update import SepConvGRU

    dt, B, H, W, D, X = torch.bfloat16, 16, 55, 128, 128, 256
    h, x, weights = gru_inputs(B, H, W, dt, seed=31)
    w1, b1 = gf.pass_weights(weights[:6], dt)
    w2, b2 = gf.pass_weights(weights[6:], dt)
    h1 = gf.gru_pass(h, x, w1, b1, 2)
    check_k7("timed inputs 1x5", h1, gf.gru_pass_plain(h, x, w1, b1, 2), w1)
    check_k7("timed inputs 5x1", gf.gru_pass(h1, x, w2, b2, 1), gf.gru_pass_plain(h1, x, w2, b2, 1),
             w2)
    module = SepConvGRU(D, X).cuda()
    with torch.no_grad():
        for i, name in enumerate(gf.GATES):
            getattr(module, name).weight.copy_(weights[2 * i])
            getattr(module, name).bias.copy_(weights[2 * i + 1])
    hc, xc = h.permute(0, 3, 1, 2).contiguous(), x.permute(0, 3, 1, 2).contiguous()
    one_h = cuda_ms(lambda: gf.gru_pass(h, x, w1, b1, 2), 20)
    one_v = cuda_ms(lambda: gf.gru_pass(h1, x, w2, b2, 1), 20)
    with torch.no_grad():
        lib_h = cuda_ms(lambda: module._pass(hc, xc, "1"), 10)
        lib_v = cuda_ms(lambda: module._pass(hc, xc, "2"), 10)
        npix = B * H * W
        row = _timing_row(
            "sepconv_gru_pass (whole GRU step: two launches)",
            lambda: gf.gru_pass(gf.gru_pass(h, x, w1, b1, 2), x, w2, b2, 1),
            lambda: gf.gru_pass_plain(gf.gru_pass_plain(h, x, w1, b1, 2), x, w2, b2, 1),
            lambda: module(hc, xc),
            2 * (npix * (2 * D + X) * 2 + w1.numel() * 2 + b1.numel() * 4),
            2 * (2 * npix * 3 * 5 * (D + X) * D), dt,
            f"B={B} {H}x{W} D={D} X={X} bf16, library = unfused SepConvGRU;")
    for k in ("ms", "plain_ms", "library_ms", "bound_ms", "fp32_core_floor_ms", "bytes", "ops"):
        row[k] /= 2
    for k in ("ms_readings", "plain_readings"):
        row[k] = [t / 2 for t in row[k]]
    row.update(per="launch: one GRU step over 2", pass_1x5_ms=one_h, pass_5x1_ms=one_v,
               library_1x5_ms=lib_h, library_5x1_ms=lib_v)
    # weight bytes per launch, computed from the launch plan at this shape
    # (nothing on the card counts them): every block reads the pass's whole
    # weight image once; the 1x5 pass runs a block per 128-position line, the
    # 5x1 pass two 55-position lines per block
    image = 5 * (D + X) * 3 * D * 2
    plan_h, plan_v = B * H * image, (B * W + 1) // 2 * image
    log(f"timing sepconv_gru_pass per launch: {row['ms']:.4f} ms (1x5 {one_h:.4f}, 5x1 "
        f"{one_v:.4f}), plain {row['plain_ms']:.4f}, unfused {row['library_ms']:.4f} (1x5 "
        f"{lib_h:.4f}, 5x1 {lib_v:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
        f"weight bytes per launch from the plan (not measured): 1x5 {plan_h / 1e9:.3f} GB, "
        f"5x1 {plan_v / 1e9:.3f} GB")
    # the fp32 route (CUDA-core FMAs, two GEMM kernels a launch) at the fp32
    # training shape (batch 2, 368x496 -> 46x62; the fp32_* keys) and the
    # batch-1 serving shape (55x128; fp32_serve_*): each pass first held
    # against the plain version, then kernel, unfused pass, kernel; the
    # yardstick is the unfused fp32 pass (three cuDNN convs and the gates,
    # TF32 off), the bound the pass's FMAs at the fp32 CUDA-core rate
    del h, x, h1, module, hc, xc
    for key, (B, H, W), seed in (("fp32", (2, 46, 62), 33), ("fp32_serve", (1, 55, 128), 34)):
        h, x, weights = gru_inputs(B, H, W, torch.float32, seed=seed)
        module = SepConvGRU(D, X).cuda()
        with torch.no_grad():
            for i, name in enumerate(gf.GATES):
                getattr(module, name).weight.copy_(weights[2 * i])
                getattr(module, name).bias.copy_(weights[2 * i + 1])
        hc, xc = h.permute(0, 3, 1, 2).contiguous(), x.permute(0, 3, 1, 2).contiguous()
        kms, lms = [], []
        for axis, part, suffix in ((2, weights[:6], "1"), (1, weights[6:], "2")):
            w, b = gf.pass_weights(part, torch.float32)
            check_k7(f"{key} timed inputs axis={axis}", gf.gru_pass(h, x, w, b, axis),
                     gf.gru_pass_plain(h, x, w, b, axis), w)
            k_a = cuda_ms(lambda: gf.gru_pass(h, x, w, b, axis), 10)
            with torch.no_grad(), gf._full_fp32():
                lms.append(cuda_ms(lambda: module._pass(hc, xc, suffix), 10))
            k_b = cuda_ms(lambda: gf.gru_pass(h, x, w, b, axis), 10)
            kms.append(min(k_a, k_b))
        bound = 2 * B * H * W * 3 * 5 * (D + X) * D / FP32_FLOPS_PER_S * 1e3
        row.update({f"{key}_1x5_ms": kms[0], f"{key}_5x1_ms": kms[1], f"{key}_ms": sum(kms) / 2,
                    f"{key}_library_1x5_ms": lms[0], f"{key}_library_5x1_ms": lms[1],
                    f"{key}_library_ms": sum(lms) / 2, f"{key}_bound_ms": bound})
        log(f"timing sepconv_gru_pass {key} (B={B} {H}x{W} fp32, CUDA cores): 1x5 {kms[0]:.4f} "
            f"ms, 5x1 {kms[1]:.4f} ms, per launch {row[key + '_ms']:.4f} ms; unfused fp32 pass "
            f"(cuDNN, TF32 off) 1x5 {lms[0]:.4f} ms, 5x1 {lms[1]:.4f} ms; bound {bound:.4f} ms "
            f"(operations: {2 * B * H * W * 3 * 5 * (D + X) * D / 1e9:.3f} GFLOP at 67 TFLOP/s)")
        del h, x, module, hc, xc
    return row


def _time_k3(radius, dt):
    """K3 at the bf16 training shape of phase train: batch 4, 368x496 -> Q =
    46*62, level 0 (46x62); the all-levels sum is logged beside it."""
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.ops.corr import window_offsets

    B = 4
    h, w = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    K = 2 * radius + 1
    flat = serving_coords(B, h, w, seed=23).reshape(B, h * w, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(24)
    g = torch.randn(B, h * w, K * K, device="cuda", generator=gen).to(dt)
    k3 = lambda: ck.corr_lookup_level_bwd(flat, g, h, w, radius, dt)
    k3_plain = lambda: ck.corr_lookup_level_bwd_plain(flat, g, h, w, radius, dt)
    # library yardstick: the input gradient of F.grid_sample over the volume
    # as [B*Q, 1, h, w] with a [B*Q, K, K, 2] grid (the formulation timed for K1)
    ox, oy = window_offsets(radius, "cuda")
    px = flat[..., 0:1] + ox
    py = flat[..., 1:2] + oy
    grid = torch.stack([2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1], dim=-1)
    grid = grid.reshape(B * h * w, K, K, 2).to(dt)
    vol = torch.zeros(B * h * w, 1, h, w, device="cuda", dtype=dt)
    g4 = g.reshape(B * h * w, 1, K, K)
    lib_fn = lambda: torch.ops.aten.grid_sampler_2d_backward(g4, vol, grid, 0, 0, True,
                                                              [True, False])
    # all four levels of one training iteration (46x62, 23x31, 11x15, 5x7),
    # each held against the plain version on these inputs before any timing
    levels = [(lvl, h // 2**lvl, w // 2**lvl) for lvl in range(4)]
    scaled = [(flat * (1.0 / 2**lvl)).contiguous() for lvl in range(4)]
    rels = []
    for (lvl, hl, wl), cl in zip(levels, scaled):
        out = ck.corr_lookup_level_bwd(cl, g, hl, wl, radius, dt)
        ref32 = ck.corr_lookup_level_bwd_plain(cl, g, hl, wl, radius, torch.float32)
        rels.append(float((out.float() - ref32).abs().max() / ref32.abs().max()))
        if not rels[-1] <= VJP_TOL[dt] or not torch.isfinite(out.float()).all():
            raise AssertionError(f"K3 timed inputs l{lvl}: max_rel {rels[-1]:.3e}")
        del out, ref32
    # eager loops, as every other kernel is timed; the kernel runs about as
    # long as its wrapper's host time, so kernel, plain version, library and
    # all four levels are also timed as CUDA-graph replays (device time)
    p1 = cuda_ms(k3_plain, 3)
    k_a = cuda_ms(k3, 20)
    k_b = cuda_ms(k3, 20)
    p2 = cuda_ms(k3_plain, 3)
    lib = cuda_ms(lib_fn, 10)
    pg = graph_ms(k3_plain, 3, reps=3)
    kg = graph_ms(k3, 10)
    libg = graph_ms(lib_fn, 10)

    def k3_all():
        for (lvl, hl, wl), cl in zip(levels, scaled):
            ck.corr_lookup_level_bwd(cl, g, hl, wl, radius, dt)

    all_eager = cuda_ms(k3_all, 20)
    all_graph = graph_ms(k3_all, 10, reps=5)
    # bytes: the dense dcorr written once, g and coords read once
    nbytes = B * h * w * (h * w * 2 + K * K * 2 + 8)
    # operations: each element of each query's in-bounds (K+1)^2 patch takes
    # at most 4 taps x 3 fp32 ops; the rest of the row is a store of zero
    x0 = torch.floor(flat[..., 0]) - radius
    y0 = torch.floor(flat[..., 1]) - radius
    nx = (torch.clamp(x0 + K, max=w - 1) - torch.clamp(x0, min=0) + 1).clamp(min=0)
    ny = (torch.clamp(y0 + K, max=h - 1) - torch.clamp(y0, min=0) + 1).clamp(min=0)
    n_ops = float((nx * ny).sum()) * 12
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_ops / FP32_FLOPS_PER_S * 1e3
    row = {
        "ms": min(k_a, k_b), "ms_readings": [k_a, k_b],
        "plain_ms": min(p1, p2), "plain_readings": [p1, p2],
        "library_ms": lib, "bytes": nbytes, "all_levels_ms": all_eager, "graph_ms": kg,
        "graph_plain_ms": pg, "graph_library_ms": libg, "all_levels_graph_ms": all_graph,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }
    log(f"timing corr_lookup_level_bwd (eager loop; CUDA-graph replays in brackets): B={B} "
        f"Q={h * w} level {h}x{w} r={radius} bf16 kernel {k_a:.4f}/{k_b:.4f} ms ({kg:.4f}), "
        f"plain {p1:.4f}/{p2:.4f} ms ({pg:.4f}), grid_sampler_2d_backward {lib:.4f} ms "
        f"({libg:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{nbytes / 1e6:.2f} MB); all four levels {all_eager:.4f} ms ({all_graph:.4f}); "
        f"max_rel vs plain by level {rels!r}")
    return row


def phase_small_update(state):
    from raft_optical_flow_tpu_torch.kernels import small_update as su
    from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
    from raft_optical_flow_tpu_torch.models.layers import fp32_policy
    from raft_optical_flow_tpu_torch.models.update import SmallUpdateBlock

    fp32_policy()
    B, H, W = 16, (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    torch.manual_seed(41)
    blk = SmallUpdateBlock(196, 96, 64).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(42)
    net = torch.tanh(torch.randn(B, 96, H, W, device="cuda", generator=g))
    inp = torch.relu(torch.randn(B, 64, H, W, device="cuda", generator=g))
    corr = torch.randn(B, H, W, 196, device="cuda", generator=g).permute(0, 3, 1, 2)
    flow = (4 * torch.randn(B, H, W, 2, device="cuda", generator=g)).permute(0, 3, 1, 2)
    p = su.block_params(blk)
    enc, gru, head = blk.encoder, blk.gru, blk.flow_head
    saved = dict(su.LAUNCHES)
    rows, total = {}, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                       "fp32_core_floor_ms": 0.0}
    with torch.no_grad():
        # the iteration's inputs as K9 makes them; h channels-last, as from the
        # second iteration on
        cor = su.conv([corr], p["convc1"], "bias_relu")
        flo1 = su.conv([flow], p["convf1"], "bias_relu")
        flo = su.conv([flo1], p["convf2"], "bias_relu")
        out = su.conv([cor, flo], p["conv"], "bias_relu")
        h0 = net.contiguous(memory_format=torch.channels_last)
        z, rh = su.conv([h0, inp, out, flow], p["gru_zr"], "gru_zr", h=h0)
        h1 = su.conv([rh, inp, out, flow], p["gru_q"], "gru_q", h=h0, z=z)
        fh = su.conv([h1], p["head1"], "bias_relu")
        cases = (
            ("convc1", [corr], "bias_relu", {}, enc.convc1.weight, enc.convc1.bias),
            ("convf1", [flow], "bias_relu", {}, enc.convf1.weight, enc.convf1.bias),
            ("convf2", [flo1], "bias_relu", {}, enc.convf2.weight, enc.convf2.bias),
            ("conv", [cor, flo], "bias_relu", {}, enc.conv.weight, enc.conv.bias),
            ("gru_zr", [h0, inp, out, flow], "gru_zr", {"h": h0},
             torch.cat([gru.convz.weight, gru.convr.weight]),
             torch.cat([gru.convz.bias, gru.convr.bias])),
            ("gru_q", [rh, inp, out, flow], "gru_q", {"h": h0, "z": z}, gru.convq.weight,
             gru.convq.bias),
            ("head1", [h1], "bias_relu", {}, head.conv1.weight, head.conv1.bias),
            ("head2", [fh], "bias", {}, head.conv2.weight, head.conv2.bias),
        )
        for name, segs, epi, kw, w, b in cases:
            fn = lambda: su.conv(segs, p[name], epi, **kw)  # noqa: E731
            plain_fn = lambda: su.conv_plain(segs, p[name], epi, **kw)  # noqa: E731
            got, want = fn(), plain_fn()
            rel = max(float((a - r).abs().max() / r.abs().max()) for a, r in zip(
                got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple)
                else (want,)))
            if not rel <= 2e-5:
                raise AssertionError(f"K9 {name}: max_rel {rel:.3e} against its plain version")
            del got, want
            x = torch.cat(segs, 1)
            pad = w.shape[-1] // 2
            lib_fn = lambda: F.conv2d(x, w, b, padding=pad)  # noqa: E731
            p1 = cuda_ms(plain_fn, 2, warmup=1)
            k_a = graph_ms(fn, 5)
            lib = graph_ms(lib_fn, 2, reps=3)
            k_b = graph_ms(fn, 5)
            p2 = cuda_ms(plain_fn, 2, warmup=1)
            eager = cuda_ms(fn, 20)
            ops = 2 * B * H * W * w.numel()
            row = {"ms": min(k_a, k_b), "ms_readings": [k_a, k_b], "eager_ms": eager,
                   "plain_ms": min(p1, p2), "library_ms": lib, "ops": ops,
                   "bound_ms": ops / FP32_ACCURATE_FLOPS_PER_S * 1e3,
                   "fp32_core_floor_ms": ops / FP32_FLOPS_PER_S * 1e3, "max_rel": rel}
            rows[name] = row
            for k in total:
                total[k] += row[k]
            log(f"small_update {name}: N={w.shape[0]} K={w[0].numel()} kernel {k_a:.4f}/{k_b:.4f}"
                f" ms (eager loop {eager:.4f}), plain {p1:.4f}/{p2:.4f} ms, cuDNN {lib:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms (three-pass TF32) / "
                f"{row['fp32_core_floor_ms']:.4f} ms (CUDA cores), {ops / 1e9:.3f} GFLOP, "
                f"{row['bound_ms'] / row['ms'] * 100:.1f}% of the bound, max_rel {rel:.2e}")
            del x
        step_k9 = graph_ms(lambda: blk(h0, inp, corr, flow), 5, reps=5)
        real = su.declines
        su.declines = lambda *a: "module path"
        try:
            step_mod = graph_ms(lambda: blk(h0, inp, corr, flow), 2, reps=3)
        finally:
            su.declines = real
    log(f"small_update per iteration (8 launches): kernels {total['ms']:.4f} ms, plain "
        f"{total['plain_ms']:.4f}, cuDNN {total['library_ms']:.4f}, bound "
        f"{total['bound_ms']:.4f} ms (three-pass TF32) / {total['fp32_core_floor_ms']:.4f} ms "
        f"(CUDA cores); the whole step {step_k9:.4f} ms, the module path {step_mod:.4f} ms")
    del blk, net, inp, corr, flow, h0, z, rh, h1, fh, cor, flo, flo1, out
    model = RAFT(RAFTConfig(small=True), device="cuda")
    frames = [torch.rand(1, 440, 1024, 3, device="cuda", generator=g) * 255 for _ in range(2)]
    su.reset_launches()
    with torch.no_grad():
        model(*frames, iters=ITERS)
    torch.cuda.synchronize()
    launches = su.LAUNCHES["small_update_conv"]
    if launches != 8 * ITERS:
        raise AssertionError(f"K9 launched {launches} times in a {ITERS}-iteration forward, "
                             f"not {8 * ITERS}")
    su.LAUNCHES.update(saved)
    state["small_update"] = {"rows": rows, "total": total, "step_ms": step_k9,
                             "module_step_ms": step_mod, "launches": launches}
    log(f"phase small_update: ok, {launches} launches a serving forward of {ITERS} iterations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of " + ",".join(PHASES) + " (default: all)")
    ap.add_argument("--parallel-worker", nargs=4, metavar=("CHECK", "WORLD", "RANK", "PORT"),
                    help=argparse.SUPPRESS)  # a process of phase parallel
    args = ap.parse_args()
    phases = [p for p in (args.phases or ",".join(PHASES)).split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if args.parallel_worker:
        check, world, rank, port = args.parallel_worker
        return parallel_worker(check, int(world), int(rank), int(port))
    state = {"multicard_asked": args.phases is not None and "multicard" in phases}
    t0 = time.perf_counter()
    if "device" not in phases:
        phases.insert(0, "device")
    for p in PHASES:
        if p in phases:
            globals()[f"phase_{p}"](state)
    log(f"all phases done in {time.perf_counter() - t0:.1f} s")
    if phases != list(PHASES):
        return 0  # a partial run prints no result
    std = state["standard"][16]
    launches = {
        "corr_lookup_level": std["launches"]["corr_lookup_level"],  # serving path
        "corr_lookup_coarse_fused": std["launches"]["corr_lookup_coarse_fused"],
        # training path, per bf16 batch-4 step
        "corr_lookup_level_bwd": state["train"]["bf16_bs4"]["launches"]["corr_lookup_level_bwd"],
    }
    # on-demand: K4 per batch-16 serving forward, K5, K6 and K6's prepass per
    # bf16 batch-4 training step (remat off)
    launches["corr_ondemand_fwd"] = state["ondemand_serving"][16]["launches"]["corr_ondemand_fwd"]
    for name in ("corr_ondemand_bwd_df1", "corr_ondemand_bwd_df2", "corr_ondemand_df2_plan"):
        launches[name] = state["ondemand_train"]["bf16_bs4"]["launches"][name]
    # K7 per fused batch-16 serving forward; K8 over its public entry's call
    # (phase kernels): no model path launches it
    launches["sepconv_gru_pass"] = state["fused_serving"]["bfloat16_bs16"]["launches"][
        "sepconv_gru_pass"]
    launches["corr_lookup_all_levels"] = state["k8_launches"]["corr_lookup_all_levels"]
    max_abs_err = {**state["max_abs_err"], **state["ondemand_max_abs_err"],
                   "sepconv_gru_pass": state["fused_max_abs_err"]}
    kernels = []
    for name, source, replaces in (
        ("corr_lookup_level", K1_SRC, K1_TPU), ("corr_lookup_coarse_fused", K1_SRC, K2_TPU),
        ("corr_lookup_level_bwd", K1_SRC, K3_TPU), ("corr_ondemand_fwd", K4_SRC, K4_TPU),
        ("corr_ondemand_bwd_df1", K4_SRC, K5_TPU), ("corr_ondemand_bwd_df2", K4_SRC, K6_TPU),
        ("corr_ondemand_df2_plan", K4_SRC, K6_TPU), ("sepconv_gru_pass", K7_SRC, K7_TPU),
        ("corr_lookup_all_levels", K1_SRC, K8_TPU),
    ):
        t = state["timing"][name]
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_abs_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    kernels[-1]["note"] = ("no model path launches it (as in the JAX package); launches "
                           "counted over one call of its public entry")
    k9 = state["small_update"]
    kernels.append({
        "name": "small_update_conv", "route": "cuda", "source": K9_SRC, "replaces": None,
        "launches": k9["launches"], "max_abs_err": None, **k9["total"],
        "bound_by": "operations", "per": "GRU iteration: 8 launches",
        "instances": k9["rows"],
        "note": "replaces no TPU kernel: the JAX package leaves these convolutions to XLA"})
    by_name = {k["name"]: k for k in kernels}
    by_name["corr_ondemand_df2_plan"]["note"] = "K6's prepass (part of K6's port)"
    for name, keys in (("corr_lookup_level", ("ms_smooth",)),
                       ("corr_lookup_coarse_fused", ("ms_smooth",)),
                       ("corr_ondemand_fwd", ("ms_smooth", "routes", "routes_smooth")),
                       ("corr_ondemand_bwd_df1", ("ms_smooth",)),
                       ("corr_ondemand_bwd_df2", ("ms_smooth", "graph_ms")),
                       ("sepconv_gru_pass", ("fp32_ms", "fp32_library_ms")),
                       ("corr_ondemand_df2_plan", ("graph_ms",))):
        by_name[name].update({k: state["timing"][name][k] for k in keys})
    # the fp32 routes of K4 (batch 16 and batch 1 at the serving shape) and K5
    # (the chairs shape), and their launches on the fp32 paths: K4 per fp32
    # serving pair (batch 1), K5 per fp32 chairs step
    fp32_launches = {
        "corr_ondemand_fwd": state["ondemand_fp32_serving"]["launches"]["corr_ondemand_fwd"],
        "corr_ondemand_bwd_df1": state["ondemand_fp32_train"]["launches"]["corr_ondemand_bwd_df1"]}
    for name, keys in (("corr_ondemand_fwd", ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "library_ms", "ms_smooth", "b1_ms", "b1_plain_ms",
                                              "b1_bound_ms", "b1_library_ms", "b1_ms_smooth")),
                       ("corr_ondemand_bwd_df1", ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms", "ms_smooth"))):
        t = state["timing"][name]
        by_name[name].update({f"fp32_{k}": t[f"fp32_{k}"] for k in keys})
        if fp32_launches[name] <= 0:
            raise AssertionError(f"{name}'s fp32 route was not launched on its fp32 path")
        by_name[name]["fp32_launches"] = fp32_launches[name]
    k3 = state["timing"]["corr_lookup_level_bwd"]
    by_name["corr_lookup_level_bwd"].update(
        {k: k3[k] for k in ("all_levels_ms", "graph_ms", "graph_plain_ms", "graph_library_ms",
                            "all_levels_graph_ms")})
    log(state["smi"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
