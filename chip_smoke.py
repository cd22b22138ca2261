#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`raft_optical_flow_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--phases device,kernels,small,standard,timing]

Phases (each prints one line when it ends; any failure raises and the exit
code is not 0):

  device    the card's name and power limit (nvidia-smi), then the nvcc build
            of the port's CUDA kernels and its seconds;
  kernels   K1 (corr_lookup_level) and K2 (corr_lookup_coarse_fused) against
            their plain PyTorch versions on the card, at the serving shapes
            (1024x440 input: Q = 55*128, levels 55x128 .. 6x16), radius 3 and
            4, fp32 and bf16 volumes and outputs, far out-of-bounds coords and
            a crop whose deepest level is empty;
  small     RAFT-small, fp32 with TF32 off, checkpoint weights, against the
            reference golden (tests/goldens/raft_small.npz); the kernels'
            launch counts must rise by `iters` each;
  standard  RAFT-standard under the bf16 policy at full width (seeded weights,
            1024x436 padded to 1024x440, 32 iterations), batch 1 and 16: the
            kernel path against the plain-lookup path, and pairs/s;
  timing    K1 and K2 at the batch-16 serving shapes: kernel, plain version,
            F.grid_sample yardstick (timed only, never used by the port), and
            the bytes bound at 3.35 TB/s.

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
PHASES = ("device", "kernels", "small", "standard", "timing")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
SERVE_HW = (436, 1024)  # bench.py::main: Sintel frames, padded to 440x1024
ITERS = 32
K1_SRC = "raft_optical_flow_tpu_torch/kernels/csrc/corr_lookup.cu"
K1_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:72"  # _lookup_level_kernel
K2_TPU = "raft_optical_flow_tpu/kernels/corr_lookup.py:337"  # _coarse_fused_kernel


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

    err = {"corr_lookup_level": 0.0, "corr_lookup_coarse_fused": 0.0}
    n_checks = 0

    def compare(pyramid, coords, radius, tag):
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
            compare(pyr, coords, radius, f"serve {vol_dtype} r{radius}")
            flat = coords.reshape(1, h * w, 2).contiguous()
            far = ck.corr_lookup_level(pyr[0], flat, radius)[:, : 4 * w]
            if bool(far.ne(0).any()):
                raise AssertionError("far out-of-bounds windows are not zero")
        del pyr
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
        f"checks={n_checks} (tolerance: fp32 |d| <= 1e-5*max|corr|, bf16 |d| <= 8e-3*|ref|) "
        f"launches={dict(ck.LAUNCHES)}")
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
    if launches != {"corr_lookup_level": iters, "corr_lookup_coarse_fused": iters}:
        raise AssertionError(f"RAFT-small launches {launches}, expected {iters} each")
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
        if launches != {"corr_lookup_level": ITERS, "corr_lookup_coarse_fused": ITERS}:
            raise AssertionError(f"RAFT-standard launches {launches}, expected {ITERS} each")
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
    ck.LAUNCHES.update(saved)  # timing launches are not the main path's
    state["timing"] = rows
    log("phase timing: ok")


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
    kernels = []
    for name, replaces in (("corr_lookup_level", K1_TPU), ("corr_lookup_coarse_fused", K2_TPU)):
        t = state["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": K1_SRC, "replaces": replaces,
            "launches": std["launches"][name], "max_abs_err": state["max_abs_err"][name],
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
