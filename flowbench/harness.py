"""The harness: a cell resolved by name, run once, its metrics read, its
result line printed.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

  - `configs/<config>.json`: the model's sizes and the policy it runs in;
  - `traffic/<traffic>.json`: the mix's parameters; its `kind` names the
    runner `traffic/<kind>.py`, which runs the mix and returns a `Record`;
  - `workloads/<cell>.json`: the cell's correctness limits;
  - `metrics/<metric>.py`: the reader of one metric, `read(record)`, which
    returns a number or None (nothing to read: the metric is left out).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_optical_flow_tpu")


@dataclasses.dataclass
class Spec:
    """One cell, resolved."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


@dataclasses.dataclass
class Context:
    """What a runner is given: the cell, the run's arguments, the device and
    the process group (rank, world), and which system stands in the
    program's place ("program", or "control": the reference one precision
    step down)."""

    spec: Spec
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0_wall: float
    rank: int = 0
    world: int = 1
    system: str = "program"


@dataclasses.dataclass
class Record:
    """What a run measured. Times in seconds, memory in bytes."""

    kind: str
    policy: str
    setup_s: float
    window_s: float
    peak_mem_bytes: int
    process_peak_bytes: int
    attempted: int
    failed: int
    world: int = 1
    pairs: int = 0                      # serving: pairs completed in the window
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    global_batch: int = 0               # training: pairs in one global step
    work_flops: float = 0.0             # model FLOPs of one call or one global step
    trace: Any = None                   # trace.Trace of the profiled stretch
    profiled: int = 0                   # calls or steps in the profiled stretch
    lookup_bound_s: Optional[float] = None  # least time of the stretch's lookups
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)  # compared readings
    checks: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    correct: Optional[bool] = None


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell: str, root: Path = ROOT, chips: Optional[int] = None) -> Spec:
    """The cell `cell` of BENCHMARK.json; or, for a name `<config>.<traffic>`
    that BENCHMARK.json does not list, that pair on `chips` cards (1 by
    default) with no metrics, from the files of that name (a mix kept ready
    for a later cell, driven by the tests and by `calibrate.py`)."""
    bench = load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if found:
        w = found[0]
        config_file = root / [c for c in bench["configs"] if c["name"] == w["config"]][0]["file"]
        traffic, chips = w["traffic"], int(w["chips"])
    else:
        config, _, traffic = cell.partition(".")
        config_file = HERE / "configs" / f"{config}.json"
        chips = chips or 1
        if not config_file.exists() or not (HERE / "traffic" / f"{traffic}.json").exists():
            raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")
    cell_file = HERE / "workloads" / f"{cell}.json"
    return Spec(
        name=cell,
        chips=chips,
        config=load_json(config_file),
        traffic=load_json(HERE / "traffic" / f"{traffic}.json"),
        limits=load_json(cell_file).get("limits", {}) if cell_file.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if found and _applies(m, cell)],
        per_layer=[m for m in bench["per_layer"] if found and _applies(m, cell)],
    )


def runner(spec: Spec) -> ModuleType:
    kind = spec.traffic["kind"]
    return load_module(HERE / "traffic" / f"{kind}.py", f"flowbench_traffic_{kind}")


def read_metrics(record: Record, metrics: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in metrics:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "flowbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number that has a limit at or under it, and
    finite; checks lists each compared number beside its limit."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())  # NaN compares False
    return bool(ok and limits), checks


def loaded_forbidden() -> List[str]:
    """Modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(record: Record, metrics: Dict[str, Any], device: Dict[str, Any]) -> str:
    out = {"correct": bool(record.correct), "attempted": record.attempted,
           "failed": record.failed, "metrics": metrics, "device": device}
    if record.trace is not None:
        out["breakdown"] = {"device_ops": record.trace.top_device_ops(10),
                            "idle_gaps": record.trace.idle_gaps(10)}
    out["checks"] = record.checks
    return json.dumps(out)


def print_checks(record: Record) -> None:
    for k, c in record.checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {bool(record.correct)}", file=sys.stderr)
    sys.stderr.flush()


def cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / "flowbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
