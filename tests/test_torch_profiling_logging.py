"""`utils/logging.py` and `utils/profiling.py` on the CPU.

  - The port's TensorBoard event file against the one the JAX package's
    `TensorBoardWriter` writes through tensorboardX, for the same scalars
    and flow image: each record's masked CRC32C checked with
    `google_crc32c`, each payload parsed by tensorboardX's `Event`
    protobuf; the same tags, steps and values, and images that decode (PIL)
    to the same pixels. The port's own reader reads both files.
  - `save_flow_grid`: the PNG holds each panel at its cell, the titles go
    to the `.json` beside it; `TeeLogger` copies stdout to its file.
  - `time_fn` and `time_calls` on the CPU; `param_count` and `param_bytes`
    against the JAX package's on the same weights; `memory_analysis`
    returns {} off the card; `compare_models` at a small size; `trace`
    writes a Chrome trace.
"""

import io
import json
import os
import struct

import google_crc32c
import numpy as np
import pytest
import torch
from PIL import Image
from tensorboardX.proto.event_pb2 import Event

from raft_optical_flow_tpu.utils import logging as jlog
from raft_optical_flow_tpu.utils import profiling as jprof
from raft_optical_flow_tpu_torch.models import RAFT, RAFTConfig
from raft_optical_flow_tpu_torch.utils import logging as tlog
from raft_optical_flow_tpu_torch.utils import profiling as tprof
from raft_optical_flow_tpu_torch.utils.flow_viz import flow_to_image
from raft_optical_flow_tpu_torch.utils.weights import load_flax_checkpoint, load_flax_npz
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALARS = [("train/loss", 2.5, 0), ("train/epe", 1.125, 10), ("val/epe", -0.75, 100)]


def _masked(data):
    crc = google_crc32c.value(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _events(path):
    """Every record of an event file, CRCs checked, as tensorboardX Events."""
    data = open(path, "rb").read()
    out, i = [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == _masked(data[i:i + 8])
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == _masked(payload)
        out.append(Event.FromString(payload))
        i += 16 + n
    return out


def _summary(events):
    rows = []
    for e in events:
        for v in e.summary.value:
            if v.HasField("image"):
                img = np.array(Image.open(io.BytesIO(v.image.encoded_image_string)))
                rows.append((v.tag, e.step, "image", v.image.height, v.image.width, img))
            else:
                rows.append((v.tag, e.step, "scalar", v.simple_value))
    return rows


def _write(writer, flow, image):
    for tag, value, step in SCALARS[:2]:
        writer.add_scalar(tag, value, step)
    writer.add_scalars({"epe": SCALARS[2][1]}, SCALARS[2][2], prefix="val/")
    writer.add_flow_image("val/flow", flow, 100)
    writer.add_image("val/frame", image, 101)
    writer.flush()
    writer.close()


def _one_file(d):
    (name,) = [f for f in os.listdir(d) if f.startswith("events.out.tfevents")]
    return os.path.join(d, name)


@pytest.fixture(scope="module")
def event_files(tmp_path_factory):
    rng = np.random.default_rng(5)
    flow = rng.normal(size=(24, 40, 2)).astype(np.float32) * 4
    image = rng.uniform(0, 1, size=(24, 40, 3)).astype(np.float32)
    jd, td = tmp_path_factory.mktemp("jax_tb"), tmp_path_factory.mktemp("port_tb")
    _write(jlog.TensorBoardWriter(str(jd)), flow, image)
    _write(tlog.TensorBoardWriter(str(td)), flow, image)
    return _one_file(str(jd)), _one_file(str(td)), flow


def test_event_file_matches_tensorboardx(event_files):
    jpath, tpath, flow = event_files
    jev, tev = _events(jpath), _events(tpath)
    assert tev[0].file_version == "brain.Event:2" == jev[0].file_version
    want, got = _summary(jev), _summary(tev)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for g, w in zip(got, want):
        if g[2] == "scalar":
            assert g[3] == w[3]
        else:
            assert g[3:5] == w[3:5]
            np.testing.assert_array_equal(g[5], w[5])
    np.testing.assert_array_equal(got[3][5], flow_to_image(flow))


def test_own_reader_reads_both_files(event_files):
    jpath, tpath, _ = event_files
    for path in (jpath, tpath):
        rows = [(v["tag"], e["step"], v.get("simple_value"))
                for e in tlog.read_event_file(path) for v in e.get("values", [])]
        assert rows[:3] == [(t, s, v) for t, v, s in SCALARS]
        assert [r[:2] for r in rows[3:]] == [("val/flow", 100), ("val/frame", 101)]


def test_reader_refuses_a_corrupt_record(event_files, tmp_path):
    _, tpath, _ = event_files
    data = bytearray(open(tpath, "rb").read())
    data[40] ^= 1
    bad = tmp_path / "events.out.tfevents.bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tlog.read_event_file(str(bad))


def test_crc32c_and_varints():
    for d in (b"", b"123456789", bytes(range(256)) * 5):
        assert tlog.crc32c(d) == google_crc32c.value(d)
    assert tlog.crc32c(b"123456789") == 0xE3069283
    assert tlog._varint(300) == b"\xac\x02" and tlog._read_varint(b"\xac\x02", 0) == (300, 2)


def test_save_flow_grid_and_tee_logger(tmp_path, capsys):
    rng = np.random.default_rng(6)
    panels = [rng.normal(size=(10, 12, 2)).astype(np.float32),
              rng.uniform(0, 1, size=(8, 12, 3)), rng.uniform(0, 255, size=(10, 9, 3))]
    path = tlog.save_flow_grid(str(tmp_path / "grid.png"), panels, ncols=2,
                               titles=["flow", "unit", "bytes"])
    grid = np.array(Image.open(path))
    assert grid.shape == (20, 24, 3)
    np.testing.assert_array_equal(grid[:10, :12], flow_to_image(panels[0]))
    np.testing.assert_array_equal(grid[:8, 12:], (panels[1] * 255).astype(np.uint8))
    assert (grid[8:10, 12:] == 255).all()
    np.testing.assert_array_equal(grid[10:, :9], panels[2].astype(np.uint8))
    meta = json.load(open(tmp_path / "grid.json"))
    assert meta["titles"] == ["flow", "unit", "bytes"] and meta["cells"] == [[0, 0], [0, 1], [1, 0]]
    with tlog.TeeLogger(str(tmp_path / "logs"), name="run") as tee:
        print("hello tee")
    assert "hello tee" in capsys.readouterr().out
    assert open(tee.path).read() == "hello tee\n"


def test_time_fn_and_param_counts():
    calls = []
    ms, out = tprof.time_fn(lambda x: calls.append(x) or x * 2, 3, num_reps=4, warmup=2,
                            device="cpu")
    assert out == 6 and len(calls) == 6 and ms >= 0.0
    times, _ = tprof.time_calls(lambda: None, num_reps=3, device="cpu")
    assert len(times) == 3
    flax = load_flax_checkpoint(os.path.join(REPO, "checkpoints", "raft_small.npz"))
    model = RAFT(RAFTConfig(small=True), device="cpu")
    model.load_state_dict(load_flax_npz(os.path.join(REPO, "checkpoints", "raft_small.npz")))
    assert tprof.param_count(model) == jprof.param_count(flax["params"])
    assert tprof.param_bytes(model) == jprof.param_bytes(flax["params"])
    assert tprof.param_count(model.state_dict()) == tprof.param_count(model)


def test_memory_analysis_off_the_card_and_compare_models():
    assert tprof.memory_analysis(lambda: torch.ones(3)) == {}
    table = tprof.compare_models(32, 48, num_reps=1, device="cpu")
    assert list(table) == ["raft-small", "liteflownet3s", "simple_flow", "ifnet"]
    for row in table.values():
        assert row["params"] > 0 and row["latency_ms"] > 0 and row["gflops"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
