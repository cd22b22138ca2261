"""The control reads `correct` false: the reference one precision step below
the configuration's policy (fp8 operands for RAFT-standard's bf16, TF32
operands for RAFT-small's fp32 with TF32 off), put in the program's place,
against the cell's own limits. On the CPU at a small size, two seeds; on
the card (marked `gpu`) at the cell's own size the readings that set the
limits come from `flowbench/calibrate.py` (PERF.md)."""

import dataclasses
import time

import pytest
import torch

from flowbench import harness

CELLS = ["raft-standard.sintel-serve-b16", "raft-small.sintel-serve-b16",
         "raft-standard.things-train-b5"]


def small_spec(cell):
    spec = harness.resolve(cell)
    t = dict(spec.traffic)
    if t["kind"] == "serve":
        t.update(batch=2, height=64, width=96, iters=6, ring=2, compare_calls=1)
    else:
        t.update(batch_per_chip=2, height=48, width=64, iters=3, ring=5)
    return dataclasses.replace(spec, traffic=t)


@pytest.mark.parametrize("seed", [7, 2**31 + 101])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed):
    spec = small_spec(cell)
    ctx = harness.Context(spec=spec, seed=seed, seconds=0.01, trace=False,
                          device=torch.device("cpu"), t0_wall=time.time(), system="control")
    rec = harness.runner(spec).run(ctx)
    assert rec.correct is False, rec.checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.resolve(cell)
    for seed in (31, 32, 33):
        ctx = harness.Context(spec=spec, seed=seed, seconds=1.0, trace=False,
                              device=torch.device("cuda", 0), t0_wall=time.time(),
                              system="control")
        rec = harness.runner(spec).run(ctx)
        assert rec.correct is False, rec.checks
