"""A run with the timed path broken underneath reads `correct` false.

Each test skips the harness's look for a card and drives the rest of a run
(set-up, window, comparison with the reference, the cell's own limits from
`workloads/<cell>.json`) on the CPU at a small size, with one fault planted
in the program:

  - serving: a pair's answer altered where it is produced (flow_up of pair
    0 moved by 2 px in an 8x8 block); half of the batch left out (the
    program runs the first half and returns its flows for both halves);
    the GRU returning its state unchanged (no update: zero flow);
  - training: the step returning its state unchanged (AdamW moves no
    parameter); half of the batch left out (the loss is the mean over the
    first half of the rows); an answer altered (the largest leaf's gradient
    doubled before the optimizer).

The same run without a fault reads `correct` true for serving (the plain
paths agree bit for bit on the CPU). The exchange between cards is only in
a four-card cell, which the benchmark does not have.
"""

import dataclasses
import time

import pytest
import torch

from flowbench import harness
from raft_optical_flow_tpu_torch.models import update as upd
from raft_optical_flow_tpu_torch.models.raft import RAFT
from raft_optical_flow_tpu_torch.train import trainer as tr

SERVE = ["raft-standard.sintel-serve-b16", "raft-small.sintel-serve-b16"]
TRAIN = ["raft-standard.things-train-b5"]
SEED = 2**31 + 101


def tiny_run(cell, **traffic):
    spec = harness.resolve(cell)
    t = dict(spec.traffic)
    if t["kind"] == "serve":
        t.update(batch=2, height=64, width=96, iters=6, ring=2, compare_calls=1)
    else:
        t.update(batch_per_chip=2, height=48, width=64, iters=3, ring=5)
    t.update(traffic)
    spec = dataclasses.replace(spec, traffic=t)
    ctx = harness.Context(spec=spec, seed=SEED, seconds=0.01, trace=False,
                          device=torch.device("cpu"), t0_wall=time.time())
    return harness.runner(spec).run(ctx)


@pytest.mark.parametrize("cell", SERVE)
def test_serving_sound(cell):
    rec = tiny_run(cell)
    assert rec.correct, rec.checks


@pytest.mark.parametrize("cell", SERVE)
def test_serving_answer_altered(cell, monkeypatch):
    orig = RAFT._test

    def altered(self, *a, **k):
        lo, up = orig(self, *a, **k)
        up = up.clone()
        up[0, 8:16, 8:16, 0] += 2.0
        return lo, up

    monkeypatch.setattr(RAFT, "_test", altered)
    rec = tiny_run(cell)
    assert rec.correct is False, rec.checks


@pytest.mark.parametrize("cell", SERVE)
def test_serving_half_batch(cell, monkeypatch):
    orig = RAFT.forward

    def half(self, image1, image2, *a, **k):
        n = image1.shape[0] // 2
        lo, up = orig(self, image1[:n], image2[:n], *a, **k)
        return torch.cat([lo, lo]), torch.cat([up, up])

    monkeypatch.setattr(RAFT, "forward", half)
    rec = tiny_run(cell)
    assert rec.correct is False, rec.checks


@pytest.mark.parametrize("cell", SERVE)
def test_serving_state_unchanged(cell, monkeypatch):
    for block in (upd.BasicUpdateBlock, upd.SmallUpdateBlock):
        orig = block.forward

        def still(self, net, inp, corr, flow, _orig=orig):
            _, mask, delta = _orig(self, net, inp, corr, flow)
            return net, mask, torch.zeros_like(delta)

        monkeypatch.setattr(block, "forward", still)
    rec = tiny_run(cell)
    assert rec.correct is False, rec.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_training_state_unchanged(cell, monkeypatch):
    orig = tr.AdamW.step

    def no_update(self, closure=None):
        saved = [p.detach().clone() for p in self.param_groups[0]["params"]]
        norm = orig(self, closure)
        with torch.no_grad():
            for p, s in zip(self.param_groups[0]["params"], saved):
                p.copy_(s)
        return norm

    monkeypatch.setattr(tr.AdamW, "step", no_update)
    rec = tiny_run(cell)
    assert rec.correct is False and rec.numbers["change_rel"] == pytest.approx(1.0), rec.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_training_half_batch(cell, monkeypatch):
    orig = tr.raft_train_step

    def half(state, batch, **k):
        n = batch["image1"].shape[0] // 2
        return orig(state, {key: v[:n] for key, v in batch.items()}, **k)

    monkeypatch.setattr(tr, "raft_train_step", half)
    rec = tiny_run(cell)
    assert rec.correct is False, rec.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_training_gradient_altered(cell, monkeypatch):
    orig = tr.AdamW.step

    def doubled(self, closure=None):
        p = max(self.param_groups[0]["params"], key=lambda t: t.numel())
        if p.grad is not None:
            p.grad = p.grad * 2.0
        return orig(self, closure)

    monkeypatch.setattr(tr.AdamW, "step", doubled)
    rec = tiny_run(cell)
    assert rec.correct is False, rec.checks
