"""The benchmark's data-driven contract, on the CPU: every cell resolves to
its files by name, names and units use the allowed characters, every
per-layer metric's `moves` metric is reported wherever it is, and the
window's arithmetic (rates, the percentile, merged busy intervals, the trace
reduction) is right on canned timings and a canned Chrome trace."""

import json
import re
from pathlib import Path

import pytest

from flowbench import harness, stats
from flowbench.trace import STRETCH, Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["flowbench"]
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.resolve(cell)
    assert spec.chips in (1, 4)
    assert (harness.HERE / "traffic" / f"{spec.traffic['kind']}.py").exists()
    assert (harness.HERE / "workloads" / f"{cell}.json").exists()
    assert spec.limits, "a cell without limits cannot be correct"
    for m in spec.end_to_end + spec.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists(), m["name"]
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["configs"]:
        assert (ROOT / e["file"]).exists() and e["file"].startswith("flowbench/")
        assert json.loads((ROOT / e["file"]).read_text())["reduced"] == e["reduced"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "workloads" in m and 1 <= len(m["layer"]) <= 200


def test_every_reader_reads_a_record():
    """Every metric reader (those of the mixes kept ready too) returns a
    number or None on a bare record of either kind."""
    for kind in ("serve", "train"):
        rec = harness.Record(kind=kind, policy="bf16", setup_s=1.0, window_s=2.0,
                             peak_mem_bytes=2**30, process_peak_bytes=2**30, attempted=4,
                             failed=0, pairs=8, latencies_s=[0.1] * 4, global_batch=5)
        for path in sorted((harness.HERE / "metrics").glob("*.py")):
            mod = harness.load_module(path, "reader_" + path.stem.replace(".", "_"))
            v = mod.read(rec)
            assert v is None or v > 0, path.name


def test_moves_reported_where_read():
    """Each per-layer metric's `moves` metric is reported in every cell the
    per-layer metric lists, and metrics of one layer name it alike."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert harness._applies(target, cell), (m["name"], cell)
    for cell in CELLS:
        spec = harness.resolve(cell)
        assert any(m["name"] != "setup_s" for m in spec.end_to_end)


def test_no_cell_name_in_code():
    code = "".join(p.read_text() for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)
    for cell in CELLS:
        assert cell not in code


def test_window_arithmetic():
    assert stats.rate(160, 32.0) == 5.0
    lat = [0.2] * 89 + [0.3] * 10 + [1.0]
    assert stats.percentile(lat, 90) == 0.3  # the 90th of 100 values
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(list(range(1, 11)), 90) == 9
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert stats.merge(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.busy(iv, 0.0, 5.0) == 3.0  # merged, not summed (3.7)
    assert stats.busy(iv, 1.0, 3.5) == 1.5
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned_trace():
    """A stretch of 100 us: two update-block ranges on the host, four kernels
    on two streams (two overlapping), a copy, and a kernel outside."""
    host = [
        _x(STRETCH, "user_annotation", 1000, 100),
        _x("aten::conv2d", "cpu_op", 1001, 10),
        _x("flowbench.update_block", "user_annotation", 1002, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 1003, 2, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1006, 2, corr=2),
        _x("aten::copy_", "cpu_op", 1040, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 1041, 2, corr=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 1050, 2, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 1080, 2, corr=5),
        _x("flowbench.update_block", "user_annotation", 1079, 5),
        _x("aten::add", "cpu_op", 1090, 5),
    ]
    dev = [
        _x("lookup_level_kernel<bf16>", "kernel", 1010, 10, tid=7, corr=1),
        _x("sm90_xmma_fprop", "kernel", 1015, 10, tid=8, corr=2),   # overlaps 1015-1020
        _x("ncclDevKernel_AllReduce", "kernel", 1045, 5, tid=9, corr=3),
        _x("Memcpy DtoH", "gpu_memcpy", 1060, 10, tid=7, corr=4),
        _x("coarse_fused_kernel<bf16>", "kernel", 1085, 5, tid=7, corr=5),
        _x("stray_kernel", "kernel", 1200, 5, tid=7),                 # after the stretch
        _x("flowbench.update_block", "gpu_user_annotation", 1010, 20, tid=7),
    ]
    return host + dev


def test_trace_reduction():
    tr = Trace(canned_trace())
    assert tr.window_s == pytest.approx(100e-6)
    # device intervals 1010-1025, 1045-1050, 1060-1070, 1085-1090: 35 us
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.launches() == 4
    assert tr.kernel_s(re.compile("lookup|coarse")) == pytest.approx(15e-6)
    assert tr.kernel_s(re.compile("nccl", re.I)) == pytest.approx(5e-6)
    # kernels launched inside the update-block ranges: corr 1, 2 and 5
    assert tr.kernel_s_in_range("flowbench.update_block") == pytest.approx(25e-6)
    top = tr.top_device_ops(2)
    assert top[0][0] in ("lookup_level_kernel<bf16>", "sm90_xmma_fprop", "Memcpy DtoH")
    # gaps 1000-1010, 1025-1045, 1070-1085 (no host operation but the
    # stretch), 1050-1060 (in the copy's cudaMemcpyAsync), 1090-1100 (aten::add)
    gaps = dict(tr.idle_gaps())
    assert set(gaps) == {"(between host operations)", "cudaMemcpyAsync", "aten::add"}
    assert gaps["(between host operations)"] == pytest.approx(45e-6)
    assert gaps["cudaMemcpyAsync"] == pytest.approx(10e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
