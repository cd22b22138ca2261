"""The readers of the program's spans on a canned Chrome trace: one call with
nested spans (the encoder span twice around the volume, two iterations of
lookup and update inside the loop), an update span that closes on the host
before its kernels run, kernels on two streams that overlap, a copy, and a
kernel launched outside every span. A trace without the program's spans (a
program older than them) gives nothing to read. Every span a reader names
is one the program lists in `utils/profiling.py::SPANS`."""

import json
from pathlib import Path

import pytest

from flowbench import harness
from flowbench.trace import STRETCH, Trace
from raft_optical_flow_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
READERS = ("encoder_ms.serve", "volume_ms.serve", "lookup_ms.serve", "update_ms.serve",
           "upsample_ms.serve", "loop_idle_ms.serve")


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _x("cudaLaunchKernel", "cuda_runtime", ts, 2, corr=corr)


def _kernel(name, ts, dur, corr, stream=7):
    return _x(name, "kernel", ts, dur, tid=stream, corr=corr)


def canned_events():
    """Times in us. Device time by span: encode 80 + 20, volume 50, lookup
    10 + 10, update 60 + 50 + 80 (the copy is no kernel), upsample 30; the
    kernel of corr 12 lies outside every span. The loop's kernels (corr 4-9)
    run from 1170 to 1400, busy 1170-1180, 1185-1190, 1200-1300 (two
    streams, merged), 1310-1400: 25 us idle."""
    spans = [
        _x(STRETCH, "user_annotation", 1000, 1000),
        _x("raft.forward", "user_annotation", 1010, 890),
        _x("raft.encode", "user_annotation", 1010, 40),
        _x("raft.volume", "user_annotation", 1050, 10),
        _x("raft.encode", "user_annotation", 1060, 10),
        _x("raft.loop", "user_annotation", 1070, 130),
        _x("raft.lookup", "user_annotation", 1070, 10),
        _x("raft.update", "user_annotation", 1090, 10),   # closes before its kernels run
        _x("raft.lookup", "user_annotation", 1110, 10),
        _x("raft.update", "user_annotation", 1120, 10),
        _x("raft.upsample", "user_annotation", 1210, 10),
    ]
    host = [
        _launch(1012, 1), _launch(1052, 2), _launch(1062, 3), _launch(1072, 4),
        _launch(1085, 5), _launch(1092, 6), _launch(1095, 7), _launch(1112, 8),
        _launch(1122, 9), _x("cudaMemcpyAsync", "cuda_runtime", 1125, 2, corr=10),
        _launch(1212, 11), _launch(1950, 12),
    ]
    dev = [
        _kernel("fprop_encoder", 1020, 80, 1),
        _kernel("gemm_volume", 1100, 50, 2),
        _kernel("fprop_cnet", 1150, 20, 3),
        _kernel("lookup_level_kernel", 1170, 10, 4),
        _kernel("elementwise_glue", 1185, 5, 5),
        _kernel("fprop_gru", 1200, 60, 6),
        _kernel("CatArrayBatchedCopy", 1250, 50, 7, stream=8),
        _kernel("lookup_level_kernel", 1310, 10, 8),
        _kernel("fprop_gru", 1320, 80, 9),
        _x("Memcpy DtoD", "gpu_memcpy", 1390, 30, tid=7, corr=10),
        _kernel("convex_upsample", 1420, 30, 11),
        _kernel("unpad_copy", 1960, 10, 12),
    ]
    return spans + host + dev


def _record(events, kind="serve", profiled=2):
    return harness.Record(kind=kind, policy="bf16", setup_s=1.0, window_s=1.0,
                          peak_mem_bytes=1, process_peak_bytes=1, attempted=1, failed=0,
                          trace=Trace(events), profiled=profiled)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "spans_reader_" + name.replace(".", "_"))


# ms per call over profiled=2 calls
WANT = {"encoder_ms.serve": 0.050, "volume_ms.serve": 0.025, "lookup_ms.serve": 0.010,
        "update_ms.serve": 0.095, "upsample_ms.serve": 0.015, "loop_idle_ms.serve": 0.0125}


@pytest.mark.parametrize("name", READERS)
def test_reading_on_the_canned_trace(name):
    assert _reader(name).read(_record(canned_events())) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_the_spans(name):
    """The parent's trace: the stretch and its kernels, no span of the
    program's; and a training record, which these readers do not serve."""
    bare = [e for e in canned_events() if not e["name"].startswith("raft.")]
    assert _reader(name).read(_record(bare)) is None
    assert _reader(name).read(_record(canned_events(), kind="train")) is None


def test_the_update_span_reads_what_the_hooks_read():
    """The benchmark's forward hooks open their range inside the program's
    update span around the same call, so both tie the same kernels."""
    events = canned_events()
    events += [_x("flowbench.update_block", "user_annotation", s["ts"] + 1, s["dur"] - 2)
               for s in events if s["name"] == "raft.update"]
    rec = _record(events)
    assert _reader("update_ms.serve").read(rec) == _reader("update_block_ms.serve").read(rec)


def test_outside_every_span():
    """The encoder, volume, loop and upsample spans cover every kernel but
    the one launched after the forward."""
    tr = Trace(canned_events())
    inside = sum(tr.kernel_s_in_range(n) for n in
                 ("raft.encode", "raft.volume", "raft.loop", "raft.upsample"))
    assert tr.kernel_s() - inside == pytest.approx(10e-6)


def test_every_span_a_reader_names_is_the_programs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["per_layer"]}
    assert set(READERS) <= listed
    named = {}
    for path in sorted((harness.HERE / "metrics").glob("*.py")):
        mod = harness.load_module(path, "spans_scan_" + path.stem.replace(".", "_"))
        if hasattr(mod, "SPAN"):
            named[path.stem] = mod.SPAN
    assert set(READERS) <= set(named)
    for name, span in named.items():
        assert span in profiling.SPANS, (name, span)
