"""LiteFlowNet3 as a benchmark configuration, on the CPU at a small size.

  - The benchmark's plain reference (`flowbench/reference/liteflownet3.py`)
    against the port on the benchmark's seeded weights and frames: bit for
    bit under fp32 and bf16, as the reference rounds where the policy does
    (on the CPU both run the same kernels for the same operations).
  - The fp8 control, and the port with the modulation's scalar map left
    out, read `correct` false against those limits through the cell's
    runner.
  - Every `lfn3.*` span opens under a profiler (a stage once a level it
    runs at; six correlations, thirteen warps and four smoothings a call),
    the stages disjoint inside `lfn3.forward` and each mechanism inside a
    stage; none opens without a profiler.
  - `flowbench/lfn3_counts.py` counts the convolutions' FLOPs as
    `FlopCounterMode` does, and its readers read a canned trace.
"""

import dataclasses
import json
import os
import time
from collections import Counter

import pytest
import torch

from flowbench import harness, lfn3_counts
from flowbench.inputs import make_batch
from flowbench.reference.liteflownet3 import PlainLFN3, param_shapes
from flowbench.trace import STRETCH, Trace
from flowbench.weights_lfn3 import make_weights
from raft_optical_flow_tpu_torch.models.liteflownet3 import (
    CostVolumeModulation,
    _corr,
    _warp,
    leaky_relu,
    liteflownet3,
)
from raft_optical_flow_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

CELL = "liteflownet3.spring-serve-b16"
H, W = 120, 180  # rescaled inside to 128 x 192
POLICY = {"fp32": torch.float32, "bf16": torch.bfloat16}
STAGES = ("lfn3.features", "lfn3.deform", "lfn3.modulate", "lfn3.match", "lfn3.subpixel",
          "lfn3.regularize", "lfn3.upsample")
MECHANISMS = ("lfn3.corr", "lfn3.warp", "lfn3.smooth")


def _images(seed, n=2):
    """The cell's frames (flowbench/inputs.py) in [0, 1], [n, 2, H, W, 3]."""
    return _runner().stacked(make_batch(seed, 0, n, H, W, "cpu"))


def _runner():
    return harness.runner(harness.resolve(CELL))


def test_parameter_names_match_the_program():
    sd = liteflownet3(device="cpu").state_dict()
    assert [(n, tuple(v.shape)) for n, v in sd.items()] == [(n, s) for n, s, _ in param_shapes()]


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_reference_matches_the_program(policy, seed):
    w = make_weights(seed, "cpu")
    model = liteflownet3(device="cpu", compute_dtype=POLICY[policy])
    model.load_state_dict(w, strict=True)
    images = _images(seed)
    out = model(images)
    ref = PlainLFN3(policy).forward(w, images)
    assert out["flows"].shape == ref["flows"].shape == (2, 1, H, W, 2)
    assert float(ref["flows"].abs().mean()) > 0.1  # the warps move something
    assert torch.equal(out["flows"], ref["flows"]) and torch.equal(out["confs"], ref["confs"])


def _small_ctx(system, seed):
    spec = harness.resolve(CELL)
    t = dict(spec.traffic, batch=2, height=H, width=W, ring=2, compare_calls=1)
    return harness.Context(spec=dataclasses.replace(spec, traffic=t), seed=seed, seconds=0.01,
                           trace=False, device=torch.device("cpu"), t0_wall=time.time(),
                           system=system)


def _without_scalar(self, f1, f2, flow, conf):
    """CostVolumeModulation with its scalar map left out: V + beta."""
    corr = _corr(f1, _warp(f2, flow, 1.0 / self.mult), 9)
    x = torch.cat([f1.to(conf.dtype), corr.to(conf.dtype), conf], dim=1)
    x = leaky_relu(self.feat_net_2(leaky_relu(self.feat_net_0(x))))
    return corr + self.mod_offset_net_2(leaky_relu(self.mod_offset_net_0(x)))


@pytest.mark.parametrize("seed", [11, 2**31 + 101])
@pytest.mark.parametrize("fault", ["control", "no_scalar"])
def test_control_and_fault_fail(fault, seed, monkeypatch):
    if fault == "no_scalar":
        monkeypatch.setattr(CostVolumeModulation, "forward", _without_scalar)
    ctx = _small_ctx("control" if fault == "control" else "program", seed)
    rec = harness.runner(ctx.spec).run(ctx)
    assert rec.correct is False, rec.checks


def test_the_program_passes_through_the_runner():
    ctx = _small_ctx("program", 2**31 + 101)
    rec = harness.runner(ctx.spec).run(ctx)
    assert rec.correct is True, rec.checks
    assert rec.pairs == 2 * rec.attempted
    assert rec.work_flops == lfn3_counts.forward_flops(2, 128, 192)


def _spans(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("lfn3.")]


def _inside(s, outer):
    return any(o[1] <= s[1] and s[2] <= o[2] for o in outer)


def test_spans_open_under_a_profiler(tmp_path):
    model = liteflownet3(device="cpu", compute_dtype=torch.bfloat16)
    with profiling.trace(str(tmp_path)):
        model(_images(1, n=1))
    spans = _spans(str(tmp_path))
    assert Counter(n for n, _, _ in spans) == {
        "lfn3.forward": 1, "lfn3.features": 1, "lfn3.deform": 2, "lfn3.modulate": 2,
        "lfn3.match": 4, "lfn3.subpixel": 4, "lfn3.regularize": 4, "lfn3.upsample": 1,
        "lfn3.corr": 6, "lfn3.warp": 13, "lfn3.smooth": 4}
    assert {n for n, _, _ in spans} <= set(profiling.SPANS)
    forward = [s for s in spans if s[0] == "lfn3.forward"]
    stages = sorted((s for s in spans if s[0] in STAGES), key=lambda s: s[1])
    assert all(_inside(s, forward) for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))  # disjoint, in order
    for s in spans:
        if s[0] in MECHANISMS:
            assert _inside(s, stages), s


def test_no_span_without_a_profiler(monkeypatch):
    made = []

    def counting(name):
        made.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    model = liteflownet3(device="cpu")
    model(_images(2, n=1))
    assert made == []


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 96, 160)])
def test_conv_flops_match_the_flop_counter(shape):
    from torch.utils.flop_counter import FlopCounterMode

    B, h, w = shape
    model = liteflownet3(device="cpu")
    counter = FlopCounterMode(display=False)
    with counter:
        model(torch.rand(B, 2, h, w, 3))
    assert counter.get_total_flops() == sum(lfn3_counts.conv_flops(B, h, w).values())


def test_correlation_counts():
    """At the cell's size: six volumes, about 2.0 GB of least bytes in bf16."""
    corrs = lfn3_counts.correlations(16, 1088, 1920)
    assert [c.patch for c in corrs] == [9, 9, 7, 9, 9, 9]
    assert sum(c.same for c in corrs) == 2
    deform3 = corrs[4]
    n = 16 * 272 * 480
    assert deform3.nbytes(2) == (n * 64 + n * 81) * 2 and deform3.ops == 2 * n * 64 * 81
    assert sum(c.nbytes(2) for c in corrs) == pytest.approx(2.034e9, rel=1e-3)
    assert lfn3_counts.corr_bound_s(16, 1088, 1920, "bf16") == pytest.approx(
        sum(c.nbytes(2) for c in corrs) / 3.35e12)


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _canned(with_spans=True):
    """Two calls' worth of one stage each, us: features 100 + 50, corr 40
    (inside modulate), warp 10 + 10, smooth 6; a kernel outside every span."""
    spans = [_x(STRETCH, "user_annotation", 0, 2000),
             _x("lfn3.forward", "user_annotation", 10, 900),
             _x("lfn3.features", "user_annotation", 10, 100),
             _x("lfn3.modulate", "user_annotation", 200, 100),
             _x("lfn3.corr", "user_annotation", 210, 20),
             _x("lfn3.warp", "user_annotation", 240, 10),
             _x("lfn3.regularize", "user_annotation", 400, 100),
             _x("lfn3.warp", "user_annotation", 410, 10),
             _x("lfn3.smooth", "user_annotation", 430, 10)]
    launches = [(20, 1), (30, 2), (215, 3), (245, 4), (415, 5), (435, 6), (1500, 7)]
    host = [_x("cudaLaunchKernel", "cuda_runtime", t, 2, corr=c) for t, c in launches]
    dev = [_x(f"k{c}", "kernel", 1000 + 100 * c, d, tid=7, corr=c)
           for c, d in ((1, 100), (2, 50), (3, 40), (4, 10), (5, 10), (6, 6), (7, 5))]
    return (spans if with_spans else spans[:1]) + host + dev


@pytest.mark.parametrize("name,want", [("lfn3_features_ms.serve", 0.075),
                                       ("lfn3_corr_ms.serve", 0.020),
                                       ("lfn3_warp_ms.serve", 0.010),
                                       ("lfn3_smooth_ms.serve", 0.003),
                                       ("lfn3_corr_roofline.serve", 25.0)])
def test_readers_on_a_canned_trace(name, want):
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "lfn3_reader_" + name.replace(".", "_"))

    def record(events):
        rec = harness.Record(kind="serve", policy="bf16", setup_s=1.0, window_s=1.0,
                             peak_mem_bytes=1, process_peak_bytes=1, attempted=1, failed=0,
                             trace=Trace(events), profiled=2)
        rec.corr_bound_s = 10e-6
        return rec

    assert reader.read(record(_canned())) == pytest.approx(want, rel=1e-9)
    assert reader.read(record(_canned(with_spans=False))) is None  # a program without them
    assert getattr(reader, "SPAN") in profiling.SPANS
