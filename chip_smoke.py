#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`raft_optical_flow_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--phases device,kernels,small,standard,train,ondemand,timing]

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
            and batch 10 fp32;
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
            (corr_ondemand_bwd_df2) against their plain versions at the
            batch-16 serving shapes, the batch-4 bf16 and batch-10 fp32
            training shapes, radius 3 and 4, far out-of-bounds coords and an
            empty deepest level, K6 twice bit for bit; RAFT-standard bf16 at
            1024x440, 32 iterations: batch 16 against the materialized kernel
            path (pairs/s, peak memory of both), batch 1 against the plain
            on-demand path; RAFT-small fp32 against the golden; one RAFT-small
            train step through K4-K6 against one through the plain versions,
            and the kernel step run twice; the bf16 batch-4 368x496 training
            step, remat off and on (ms/step, peak memory, launches per step);
  timing    K1, K2 and K4 at the batch-16 serving shapes, K3, K5 and K6 at
            the batch-4 training shapes, each first held against its plain
            version on the inputs it is timed on: kernel, plain version, a
            PyTorch library yardstick (F.grid_sample, its backward, and for
            K4-K6 the dot with fmap1; timed only, never used by the port),
            and the bound: bytes at 3.35 TB/s or operations at the peak rate
            of the operands' type, whichever is larger.

With every phase run (the default) the last two lines are a JSON object of
per-kernel numbers and `{"ok": true, "device": {...}}`. Runs on CUDA only: it
exits non-zero without a card, and imports only torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "kernels", "small", "standard", "train", "ondemand", "timing")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16, dense tensor cores
FLOPS_PER_S = {torch.float32: FP32_FLOPS_PER_S, torch.bfloat16: BF16_FLOPS_PER_S}
SERVE_HW = (436, 1024)  # bench.py::main: Sintel frames, padded to 440x1024
ITERS = 32
TRAIN_HW = (368, 496)  # tools/bench_train.py `standard` and the chairs crop
TRAIN_ITERS = 12
K1_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/corr_lookup.cu"
K1_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:72"  # _lookup_level_kernel
K2_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:337"  # _coarse_fused_kernel
K3_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:162"  # _lookup_level_bwd_kernel
K4_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/corr_ondemand.cu"
K4_TPU = "raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:129"  # _fwd_level_kernel
K5_TPU = "raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:251"  # _bwd_df1_kernel
K6_TPU = "raft_optical_flow_tpu/kernels/corr_ondemand_pallas.py:266"  # _bwd_df2_kernel
VJP_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # utils/grad_parity.py's gates


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
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    built = "built" if _build.build_seconds is not None else "reused"
    log(f"phase device: ok, kernels {built} in {secs:.2f} s ({lib.name})")


def _check_close(name, out, ref32, out_dtype, scale):
    """fp32: |out - ref| <= 1e-5 * max|corr|; bf16: within 8e-3 relative."""
    diff = (out.float() - ref32).abs()
    if out_dtype == torch.float32:
        ok = bool(diff.max() <= 1e-5 * scale)
    else:
        ok = bool((diff <= 8e-3 * ref32.abs()).all())
    if not ok or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: max|diff| {float(diff.max()):.3e} (scale {scale:.3e})")


def phase_kernels(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.ops.corr import corr_pyramid_lookup

    err = {"corr_lookup_level": 0.0, "corr_lookup_coarse_fused": 0.0, "corr_lookup_level_bwd": 0.0}
    k3_rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_checks = 0

    def compare(pyramid, coords, radius, tag, far_rows=0):
        nonlocal n_checks
        B, h, w, _ = coords.shape
        flat = coords.reshape(B, h * w, 2).contiguous()
        scale = max(float(c.float().abs().max()) for c in pyramid if c.numel())
        for out_dtype in (torch.float32, torch.bfloat16):
            for lvl, c in enumerate(pyramid):
                if c.shape[2] == 0 or c.shape[3] == 0:
                    continue
                cl = (flat * (1.0 / 2**lvl)).contiguous()
                out = ck.corr_lookup_level(c, cl, radius, out_dtype)
                ref32 = ck.corr_lookup_level_plain(c, cl, radius, torch.float32)
                ref = ref32.to(out_dtype)
                _check_close(f"K1 {tag} l{lvl} {out_dtype}", out, ref32, out_dtype, scale)
                err["corr_lookup_level"] = max(err["corr_lookup_level"],
                                               float((out.float() - ref.float()).abs().max()))
                n_checks += 1
            out = ck.corr_lookup_coarse_fused(pyramid[1:], flat, radius, out_dtype)
            ref32 = ck.corr_lookup_coarse_fused_plain(pyramid[1:], flat, radius, torch.float32)
            ref = ref32.to(out_dtype)
            _check_close(f"K2 {tag} {out_dtype}", out, ref32, out_dtype, scale)
            err["corr_lookup_coarse_fused"] = max(err["corr_lookup_coarse_fused"],
                                                  float((out.float() - ref.float()).abs().max()))
            n_checks += 1
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
    # a 56x128 crop: levels 7x16, 3x8, 1x4, 0x2 (the deepest is empty)
    for vol_dtype in (torch.float32, torch.bfloat16):
        pyr = serving_pyramid(2, 7, 16, vol_dtype, seed=9)
        assert pyr[-1].shape[2] == 0
        coords = serving_coords(2, 7, 16, seed=10)
        compare(pyr, coords, 3, f"empty-level {vol_dtype}")
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
        f"checks={n_checks} (tolerance: K1/K2 fp32 |d| <= 1e-5*max|corr|, bf16 |d| <= "
        f"8e-3*|ref|; K3 max_rel <= 2e-5 fp32 volume, 3e-2 bf16) launches={dict(ck.LAUNCHES)}")
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
                    "corr_lookup_level_bwd": 0}:
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
                        "corr_lookup_level_bwd": 0}:
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

    return {**ck.LAUNCHES, **co.LAUNCHES}


def reset_all():
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    ck.reset_launches()
    co.reset_launches()


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
    """max|d| / max|ref| for each layer (its weight and bias together):
    each layer on its own scale, so fnet, the only part the lookup's
    gradient reaches, is not measured against the update block's larger
    gradient. A conv bias in front of an instance norm has a zero gradient
    up to rounding; its layer's weight gradient gives it its scale."""
    diff, ref = {}, {}
    for k, v in ref_grads.items():
        layer = k.rsplit(".", 1)[0]
        diff[layer] = max(diff.get(layer, 0.0), float((grads[k] - v).abs().max()))
        ref[layer] = max(ref.get(layer, 0.0), float(v.abs().max()))
    return {n: diff[n] / ref[n] for n in ref}


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
                    "corr_lookup_level_bwd": 0}:
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


def compare_ondemand(f1, levels, coords, radius, tag, err, rels, far_rows=0, w=0):
    """K4, K5 and K6 against their plain versions on one set of inputs."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    dt = f1.dtype
    out = co.corr_ondemand_fwd(f1, levels, coords, radius, dt)
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
        compare_ondemand(f1, levels, coords.reshape(B, h * w, 2).contiguous(), radius,
                         f"serve B={B} C={C} r={radius} {dt}", err, rels, far_rows=4, w=w)
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
        compare_ondemand(f1, levels, coords, 4, f"train B={B} {dt}", err, rels)
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
        f"K5, K6 max_rel 2e-5; K6 twice bit for bit) launches={dict(co.LAUNCHES)}")


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
              "corr_ondemand_bwd_df2": iters}
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
                    "corr_ondemand_bwd_df1": TRAIN_ITERS, "corr_ondemand_bwd_df2": TRAIN_ITERS}
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


def phase_ondemand(state):
    _ondemand_kernel_checks(state)
    _ondemand_serving(state)
    _ondemand_small(state)
    _ondemand_train(state)
    log("phase ondemand: ok")


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

    B, radius, dt = 16, 4, torch.bfloat16
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    pyr = serving_pyramid(B, h, w, dt, seed=21)
    coords = serving_coords(B, h, w, seed=22)
    flat = coords.reshape(B, h * w, 2).contiguous()
    saved = dict(ck.LAUNCHES)
    saved_ondemand = dict(co.LAUNCHES)
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

    for name, fn, plain_fn, lib_fn, levels in (
        ("corr_lookup_level", k1, k1_plain, gs0, [(0, pyr[0])]),
        ("corr_lookup_coarse_fused", k2, k2_plain, gs2, list(enumerate(pyr))[1:]),
    ):
        lvl_fn = levels[0][0]
        ref32 = (ck.corr_lookup_level_plain(pyr[0], flat, radius, torch.float32) if lvl_fn == 0
                 else ck.corr_lookup_coarse_fused_plain(pyr[1:], flat, radius, torch.float32))
        _check_close(f"{name} timed inputs", fn(), ref32, dt, 0.0)
        del ref32
        # plain, kernel, kernel, plain: two readings each within one call
        p1 = cuda_ms(plain_fn, 3)
        k_a = cuda_ms(fn, 20)
        k_b = cuda_ms(fn, 20)
        p2 = cuda_ms(plain_fn, 3)
        lib = cuda_ms(lib_fn, 10)
        nbytes = _bytes_needed(levels, flat, radius, 2)
        K = 2 * radius + 1
        n_out = B * h * w * K * K * len(levels)
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops = n_out * 17 / FP32_FLOPS_PER_S * 1e3  # 17 fp32 ops per output
        rows[name] = {
            "ms": min(k_a, k_b), "ms_readings": [k_a, k_b],
            "plain_ms": min(p1, p2), "plain_readings": [p1, p2],
            "library_ms": lib, "bytes": nbytes,
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        r = rows[name]
        log(f"timing {name}: B={B} r={radius} bf16 kernel {k_a:.4f}/{k_b:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, grid_sample {lib:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {nbytes / 1e6:.2f} MB)")
    del pyr
    rows["corr_lookup_level_bwd"] = _time_k3(radius, dt)
    _time_ondemand(rows)
    ck.LAUNCHES.update(saved)  # timing launches are not the main path's
    co.LAUNCHES.update(saved_ondemand)
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


def _timing_row(name, fn, plain_fn, lib_fn, nbytes, n_ops, dtype, detail):
    """plain, kernel, kernel, plain (two readings each, in one call), the
    library yardstick, and the bound."""
    p1 = cuda_ms(plain_fn, 3)
    k_a = cuda_ms(fn, 20)
    k_b = cuda_ms(fn, 20)
    p2 = cuda_ms(plain_fn, 3)
    lib = cuda_ms(lib_fn, 5)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = n_ops / FLOPS_PER_S[dtype] * 1e3
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
    """K4 at the batch-16 serving shape, K5 and K6 at the batch-4 training
    shape, bf16 operands and cotangents, r = 4, C = 256; each first held
    against its plain version on the very inputs it is timed on."""
    from raft_optical_flow_tpu_torch.kernels import corr_ondemand as co

    dt, radius = torch.bfloat16, 4
    K2 = (2 * radius + 1) ** 2
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    B, C = 16, 256
    f1, levels = ondemand_inputs(B, h, w, dt, seed=25)
    coords = serving_coords(B, h, w, seed=26).reshape(B, h * w, 2).contiguous()
    fn = lambda: co.corr_ondemand_fwd(f1, levels, coords, radius, dt)
    plain_fn = lambda: co.corr_ondemand_fwd_plain(f1, levels, coords, radius, dt)
    check_k4("K4 timed inputs", fn(), co.corr_ondemand_fwd_plain(f1, levels, coords, radius))
    lib_fwd, *_ = _ondemand_library(f1, levels, coords, radius)
    lib_fn = lambda: lib_fwd().detach()
    Q = h * w
    taps = _ondemand_taps(levels, coords, radius)
    nbytes = (f1.numel() * 2 + sum(f.numel() for f in levels) * 2 + B * Q * 8
              + B * Q * len(levels) * K2 * 2)
    n_ops = taps * C * 2 + B * Q * len(levels) * K2 * 9  # the dots, then 9 ops per window value
    rows["corr_ondemand_fwd"] = _timing_row(
        "corr_ondemand_fwd", fn, plain_fn, lib_fn, nbytes, n_ops, dt,
        f"B={B} Q={Q} C={C} r={radius} bf16 levels 55x128..6x16, {taps:.0f} in-bounds taps;")
    del f1, levels, coords, lib_fwd
    torch.cuda.empty_cache()

    B = 4
    h, w = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    Q = h * w
    f1, levels = ondemand_inputs(B, h, w, dt, seed=27)
    coords = serving_coords(B, h, w, seed=28).reshape(B, Q, 2).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(29)
    g = torch.randn(B, Q, len(levels) * K2, device="cuda", generator=gen).to(dt)
    shapes = [tuple(f.shape[1:3]) for f in levels]
    check_rel("K5 timed inputs", co.corr_ondemand_bwd_df1(levels, coords, g, radius),
              co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius))
    for lvl, (a, b) in enumerate(zip(co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius),
                                     co.corr_ondemand_bwd_df2_plain(f1, coords, g, shapes,
                                                                    radius))):
        check_rel(f"K6 timed inputs l{lvl}", a, b)
    lib_fwd, f1_leaf, img_leaves = _ondemand_library(f1, levels, coords, radius)
    out = lib_fwd()
    taps = _ondemand_taps(levels, coords, radius)
    n_ops = taps * C * 2 + taps * 6  # the dots, and each tap's cotangent
    common = B * Q * 8 + g.numel() * 2
    detail = f"B={B} Q={Q} C={C} r={radius} bf16 levels 46x62..5x7, {taps:.0f} in-bounds taps;"
    rows["corr_ondemand_bwd_df1"] = _timing_row(
        "corr_ondemand_bwd_df1", lambda: co.corr_ondemand_bwd_df1(levels, coords, g, radius),
        lambda: co.corr_ondemand_bwd_df1_plain(levels, coords, g, radius),
        lambda: torch.autograd.grad(out, [f1_leaf], g, retain_graph=True),
        common + sum(f.numel() for f in levels) * 2 + B * Q * C * 4, n_ops, dt, detail)
    rows["corr_ondemand_bwd_df2"] = _timing_row(
        "corr_ondemand_bwd_df2", lambda: co.corr_ondemand_bwd_df2(f1, coords, g, shapes, radius),
        lambda: co.corr_ondemand_bwd_df2_plain(f1, coords, g, shapes, radius),
        lambda: torch.autograd.grad(out, img_leaves, g, retain_graph=True),
        common + f1.numel() * 2 + sum(f.numel() for f in levels) * 4, n_ops, dt, detail)
    del out


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
    p1 = cuda_ms(k3_plain, 3)
    k_a = cuda_ms(k3, 20)
    k_b = cuda_ms(k3, 20)
    p2 = cuda_ms(k3_plain, 3)
    lib = cuda_ms(lib_fn, 10)

    def k3_all():
        for (lvl, hl, wl), cl in zip(levels, scaled):
            ck.corr_lookup_level_bwd(cl, g, hl, wl, radius, dt)

    all_ms = cuda_ms(k3_all, 20)
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
        "library_ms": lib, "bytes": nbytes, "all_levels_ms": all_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }
    log(f"timing corr_lookup_level_bwd: B={B} Q={h * w} level {h}x{w} r={radius} bf16 kernel "
        f"{k_a:.4f}/{k_b:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, grid_sampler_2d_backward "
        f"{lib:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{nbytes / 1e6:.2f} MB); all four levels {all_ms:.4f} ms; max_rel vs plain by "
        f"level {rels!r}")
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    state = {}
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
    # on-demand: K4 per batch-16 serving forward, K5 and K6 per bf16 batch-4
    # training step (remat off)
    launches["corr_ondemand_fwd"] = state["ondemand_serving"][16]["launches"]["corr_ondemand_fwd"]
    for name in ("corr_ondemand_bwd_df1", "corr_ondemand_bwd_df2"):
        launches[name] = state["ondemand_train"]["bf16_bs4"]["launches"][name]
    max_abs_err = {**state["max_abs_err"], **state["ondemand_max_abs_err"]}
    kernels = []
    for name, source, replaces in (
        ("corr_lookup_level", K1_SRC, K1_TPU), ("corr_lookup_coarse_fused", K1_SRC, K2_TPU),
        ("corr_lookup_level_bwd", K1_SRC, K3_TPU), ("corr_ondemand_fwd", K4_SRC, K4_TPU),
        ("corr_ondemand_bwd_df1", K4_SRC, K5_TPU), ("corr_ondemand_bwd_df2", K4_SRC, K6_TPU),
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
    log(state["smi"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
