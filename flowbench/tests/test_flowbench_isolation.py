"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Module names are compared by their
top-level name, whole: the port's package name begins with the JAX
package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS += ["raft-standard.things-train-b5"]  # the training mix kept ready
FORBIDDEN = {"jax", "jaxlib", "flax", "raft_optical_flow_tpu"}

REHEARSAL = """
import dataclasses, json, sys, time
import torch
sys.path.insert(0, {root!r})
from flowbench import run, harness
assert run.main(["--workload", {cell!r}, "--seed", "2147483659", "--seconds", "1"]) == 2
spec = harness.resolve({cell!r})
t = dict(spec.traffic)
t.update(batch=1, batch_per_chip=1, height=48, width=64, iters=2, ring=3, compare_calls=1)
spec = dataclasses.replace(spec, traffic=t)
ctx = harness.Context(spec=spec, seed=2147483659, seconds=0.01, trace=False,
                      device=torch.device("cpu"), t0_wall=time.time())
rec = harness.runner(spec).run(ctx)
harness.read_metrics(rec, spec.end_to_end)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_cell_setup_loads_no_jax(cell):
    """The run refuses to measure without a card (exit code 2); the cell's
    set-up, window and comparison then run on the CPU at a tiny size; no
    forbidden module is loaded."""
    out = subprocess.run([sys.executable, "-c", REHEARSAL.format(root=str(ROOT), cell=cell)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "raft_optical_flow_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "flowbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("torch", "flowbench", "__future__", "dataclasses",
                                           "typing", "math"), (path.name, n)
    code = ("import sys; sys.path.insert(0, %r); import flowbench.reference.raft, "
            "flowbench.reference.train, flowbench.weights, flowbench.flops, flowbench.bytes; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert "raft_optical_flow_tpu_torch" not in loaded and not loaded & FORBIDDEN
