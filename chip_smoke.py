#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`raft_optical_flow_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--phases device,kernels,small,standard,train,timing]

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
            moved, ms/step, peak memory;
  timing    K1 and K2 at the batch-16 serving shapes, K3 at the batch-4
            training shapes, each first held against its plain version on
            the inputs it is timed on: kernel, plain version, a PyTorch library
            yardstick (F.grid_sample and its backward; timed only, never used
            by the port), and the bytes bound at 3.35 TB/s.

With every phase run (the default) the last two lines are a JSON object of
per-kernel numbers and `{"ok": true, "device": {...}}`. Runs on CUDA only: it
exits non-zero without a card, and imports only torch, numpy and the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "kernels", "small", "standard", "train", "timing")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
SERVE_HW = (436, 1024)  # bench.py::main: Sintel frames, padded to 440x1024
ITERS = 32
TRAIN_HW = (368, 496)  # tools/bench_train.py `standard` and the chairs crop
TRAIN_ITERS = 12
K1_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/corr_lookup.cu"
K1_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:72"  # _lookup_level_kernel
K2_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:337"  # _coarse_fused_kernel
K3_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:162"  # _lookup_level_bwd_kernel
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
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.train.trainer import raft_train_step

    times, metrics = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        metrics = raft_train_step(st, batch, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if dict(ck.LAUNCHES) != expect:
            raise AssertionError(f"train step launches {dict(ck.LAUNCHES)}, expected {expect}")
    return times, {k: float(v) for k, v in metrics.items()}


def phase_train(state):
    from raft_optical_flow_tpu_torch.kernels import corr_lookup as ck
    from raft_optical_flow_tpu_torch.models import RAFTConfig
    from raft_optical_flow_tpu_torch.train.configs import STANDARD_CURRICULUM, StageConfig
    from raft_optical_flow_tpu_torch.train.trainer import create_train_state, raft_train_step
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
    # same weights; cuDNN's backward may pick non-deterministic algorithms
    # and the backward of index_select adds with atomics, so PyTorch's
    # deterministic algorithms are on for this comparison only
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        steps = {}
        for impl, expect in (("cuda", 4 * iters), ("plain", 0), ("cuda again", 4 * iters)):
            cfg = RAFTConfig(small=True, corr_impl=impl.split()[0])
            s = create_train_state(cfg, stage, ckpt, "cuda")
            ck.reset_launches()
            m = raft_train_step(s, batch, iters=iters)
            torch.cuda.synchronize()
            got = dict(ck.LAUNCHES)
            if got != {"corr_lookup_level": expect, "corr_lookup_coarse_fused": 0,
                       "corr_lookup_level_bwd": expect}:
                raise AssertionError(f"train step ({impl}) launches {got}")
            steps[impl] = (float(m["loss"]), {k: p.grad for k, p in s.model.named_parameters()})
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        torch.use_deterministic_algorithms(False)
    (loss_k, grads_k), (loss_p, grads_p) = steps["cuda"], steps["plain"]

    def layer_max_rel(grads, ref_grads):
        """max|d| / max|ref| for each layer (its weight and bias together):
        each layer on its own scale, so fnet, the only part K3's gradient
        reaches, is not measured against the update block's larger gradient.
        A conv bias in front of an instance norm has a zero gradient up to
        rounding; its layer's weight gradient gives it its scale."""
        diff, ref = {}, {}
        for k, v in ref_grads.items():
            layer = k.rsplit(".", 1)[0]
            diff[layer] = max(diff.get(layer, 0.0), float((grads[k] - v).abs().max()))
            ref[layer] = max(ref.get(layer, 0.0), float(v.abs().max()))
        return {n: diff[n] / ref[n] for n in ref}

    layer_rel = layer_max_rel(grads_k, grads_p)
    # the same kernel step twice: 0 unless something in the step is not
    # deterministic
    noise = layer_max_rel(steps["cuda again"][1], grads_k)
    fnet = [k for k in grads_p if k.startswith("fnet.")]
    fnet_rel = (max(float((grads_k[k] - grads_p[k]).abs().max()) for k in fnet)
                / max(float(grads_p[k].abs().max()) for k in fnet))
    worst = max(layer_rel, key=layer_rel.get)
    worst_noise = max(noise, key=noise.get)
    log(f"train small fp32: train_iters={iters} preds[-1] EPE vs golden mean={epe.mean()!r} "
        f"max={epe.max()!r}; step kernel-vs-plain loss {loss_k!r} vs {loss_p!r}, "
        f"gradient max_rel per layer: worst {worst} {layer_rel[worst]!r} (gate 2e-5 each), "
        f"fnet as a whole {fnet_rel!r}; "
        f"kernel step vs itself: worst {worst_noise} {noise[worst_noise]!r} "
        f"(deterministic algorithms on for this comparison)")
    log("  gradient max_rel by layer, kernel vs plain: "
        + " ".join(f"{n}={r:.3e}" for n, r in layer_rel.items()))
    if not (epe.mean() < 1e-3 and loss_k == loss_p
            and all(r <= 2e-5 for r in layer_rel.values())):
        raise AssertionError("RAFT-small training does not match the golden or the plain path")
    del st, steps, grads_k, grads_p, preds
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

    B, radius, dt = 16, 4, torch.bfloat16
    h, w = (SERVE_HW[0] + 4) // 8, SERVE_HW[1] // 8
    pyr = serving_pyramid(B, h, w, dt, seed=21)
    coords = serving_coords(B, h, w, seed=22)
    flat = coords.reshape(B, h * w, 2).contiguous()
    saved = dict(ck.LAUNCHES)
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
    ck.LAUNCHES.update(saved)  # timing launches are not the main path's
    state["timing"] = rows
    log("phase timing: ok")


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
    kernels = []
    for name, replaces in (("corr_lookup_level", K1_TPU), ("corr_lookup_coarse_fused", K2_TPU),
                           ("corr_lookup_level_bwd", K3_TPU)):
        t = state["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": K1_SRC, "replaces": replaces,
            "launches": launches[name], "max_abs_err": state["max_abs_err"][name],
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
