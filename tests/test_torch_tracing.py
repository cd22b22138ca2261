"""The port's spans (`utils/profiling.py::span`) on the CPU.

  - With no profiler recording, `span` hands back one shared null context
    and constructs no `record_function`, through a whole RAFT forward.
  - Under `profiling.trace`, a tiny RAFT-small and RAFT-standard forward,
    on the materialized and the on-demand route, writes each span as often
    as the model's docstring says, nested in `raft.forward`, with each
    iteration's lookup and update inside `raft.loop`.
  - A training step writes `train.loss`, `train.backward` and
    `train.optimizer` once and `raft.upsample` once an iteration;
    `train.allreduce` only inside a data group; `train_loop` one
    `train.data` a batch.
  - Outputs, gradients and updated parameters are bit for bit the same with
    the profiler on and off.
  - The names the port's sources open are exactly `SPANS`.
"""

import ast
import json
import os
from collections import Counter

import pytest
import torch
import torch.distributed as dist

from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.parallel import distributed
from raft_optical_flow_tpu_torch.train.configs import StageConfig
from raft_optical_flow_tpu_torch.train.trainer import (
    RAFTTrainer,
    create_train_state,
    raft_train_step,
)
from raft_optical_flow_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 3
H, W = 64, 64
ROUTES = {
    "small": RAFTConfig(small=True),
    "standard": RAFTConfig(),
    "small-ondemand": RAFTConfig(small=True, alternate_corr=True),
    "standard-ondemand": RAFTConfig(alternate_corr=True),
}


def _frames(n=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(n, H, W, 3, generator=g) * 255.0 for _ in range(2))


def _batch(n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    i1, i2 = (torch.rand(n, H, W, 3, generator=g) * 255.0 for _ in range(2))
    flow = torch.rand(n, H, W, 2, generator=g) * 4.0 - 2.0
    return {"image1": i1, "image2": i2, "flow": flow, "valid": torch.ones(n, H, W)}


def _stage(**kw):
    return StageConfig(name="trace", stage="things", num_steps=10, batch_size=2, lr=1e-4,
                       image_size=(H, W), iters=ITERS, **kw)


def _spans(log_dir):
    """(name, start, end) of every span of the port in the trace `trace` wrote."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"] in profiling.SPANS]


def _inside(span, outer):
    return any(o[1] <= span[1] and span[2] <= o[2] for o in outer)


@pytest.mark.parametrize("route", ["small", "standard"])
def test_untraced_span_constructs_nothing(route, monkeypatch):
    made = []

    def counting(name):
        made.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    model = RAFT(ROUTES[route], device="cpu")
    assert profiling.span("raft.lookup") is profiling.span("raft.update")
    model(*_frames(), iters=ITERS, test_mode=True)
    assert made == []
    with torch.profiler.profile():
        model(*_frames(), iters=1, test_mode=True)
    assert Counter(made)["raft.forward"] == 1  # the counter sees spans when one records


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_span_counts_and_nesting(route, tmp_path):
    model = RAFT(ROUTES[route], device="cpu")
    with profiling.trace(str(tmp_path)):
        model(*_frames(), iters=ITERS, test_mode=True)
    spans = _spans(str(tmp_path))
    counts = Counter(name for name, _, _ in spans)
    assert counts == {"raft.forward": 1, "raft.encode": 2, "raft.volume": 1, "raft.loop": 1,
                      "raft.lookup": ITERS, "raft.update": ITERS, "raft.upsample": 1}
    by = {n: [s for s in spans if s[0] == n] for n in counts}
    for s in spans:
        if s[0] != "raft.forward":
            assert _inside(s, by["raft.forward"]), s
    for s in by["raft.lookup"] + by["raft.update"]:
        assert _inside(s, by["raft.loop"]), s
    for n in ("raft.encode", "raft.volume", "raft.upsample"):
        assert not any(_inside(s, by["raft.loop"]) for s in by[n]), n
    # the volume lies between the two encoder spans
    enc = sorted(by["raft.encode"], key=lambda s: s[1])
    assert enc[0][2] <= by["raft.volume"][0][1] <= by["raft.volume"][0][2] <= enc[1][1]


@pytest.mark.parametrize("small", [True, False], ids=["small", "standard"])
def test_train_step_spans(small, tmp_path):
    state = create_train_state(RAFTConfig(small=small), _stage(), device="cpu")
    with profiling.trace(str(tmp_path)):
        raft_train_step(state, _batch(), iters=ITERS)
    counts = Counter(name for name, _, _ in _spans(str(tmp_path)))
    assert counts["train.loss"] == counts["train.backward"] == counts["train.optimizer"] == 1
    assert counts["raft.forward"] == 1
    assert counts["raft.upsample"] == counts["raft.lookup"] == counts["raft.update"] == ITERS
    assert counts["train.allreduce"] == 0 and counts["train.data"] == 0


def test_allreduce_span_inside_a_data_group(tmp_path):
    state = create_train_state(RAFTConfig(small=True), _stage(), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        with distributed.data_parallel(dist.group.WORLD):
            with profiling.trace(str(tmp_path / "prof")):
                raft_train_step(state, _batch(), iters=ITERS)
    finally:
        dist.destroy_process_group()
    counts = Counter(name for name, _, _ in _spans(str(tmp_path / "prof")))
    assert counts["train.allreduce"] == 1 and counts["train.backward"] == 1


def test_train_loop_spans_each_batch_wait(tmp_path):
    trainer = RAFTTrainer(_stage(small=True), checkpoint_dir=str(tmp_path / "ckpt"), device="cpu")
    batches = iter([_batch(seed=s) for s in (1, 2)])
    with profiling.trace(str(tmp_path / "prof")):
        trainer.run(batches, num_steps=2)
    counts = Counter(name for name, _, _ in _spans(str(tmp_path / "prof")))
    assert counts["train.data"] == 2 and counts["train.optimizer"] == 2


@pytest.mark.parametrize("route", ["small", "standard", "standard-ondemand"])
def test_profiler_changes_no_bit(route):
    model = RAFT(ROUTES[route], device="cpu")
    frames = _frames(2)
    off = model(*frames, iters=ITERS, test_mode=True)
    with torch.profiler.profile():
        on = model(*frames, iters=ITERS, test_mode=True)
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    def step(traced):
        state = create_train_state(ROUTES[route], _stage(), device="cpu")
        if traced:
            with torch.profiler.profile():
                m = raft_train_step(state, _batch(), iters=ITERS)
        else:
            m = raft_train_step(state, _batch(), iters=ITERS)
        params = dict(state.model.named_parameters())
        return m, {k: p.grad for k, p in params.items()}, {k: p.detach() for k, p in params.items()}

    (m0, g0, p0), (m1, g1, p1) = step(False), step(True)
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    for k in p0:
        assert (g0[k] is None) == (g1[k] is None), k
        if g0[k] is not None:
            assert torch.equal(g0[k], g1[k]), k
        assert torch.equal(p0[k], p1[k]), k


def _opened_names():
    """The literal names of every `span(...)` call in the port's sources."""
    names = set()
    port = os.path.join(REPO, "raft_optical_flow_tpu_torch")
    for root, dirs, files in os.walk(port):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id == "span"):
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), (f, ast.dump(arg))
                    names.add(arg.value)
    return names


def test_every_opened_name_is_listed():
    assert _opened_names() == set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
