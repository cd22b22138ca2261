"""Observability: TensorBoard event files, flow-image grids, a tee logger.

Counterpart of `raft_optical_flow_tpu/utils/logging.py`, without
tensorboardX, protobuf or matplotlib (none is on the card's machine):

  - `TensorBoardWriter` writes TensorBoard's event files itself. A file is a
    sequence of records: the payload's length (uint64, little-endian), the
    masked CRC32C of those 8 bytes, the payload, the masked CRC32C of the
    payload. A payload is an `Event` protobuf, hand-encoded: `wall_time`,
    `step`, and a `Summary` whose `Value` holds a `simple_value` (scalars)
    or an `Image` with a PNG (`data/frame_utils.py::encode_png`). The
    first record carries `file_version` "brain.Event:2", as TensorBoard's
    writers put it. `read_event_file` reads such a file back, checking
    every CRC.
  - `save_flow_grid` tiles flow visualizations and images into one PNG.
  - `TeeLogger` copies stdout to a timestamped log file.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import time
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np

from raft_optical_flow_tpu_torch.data.frame_utils import decode_png, encode_png
from raft_optical_flow_tpu_torch.utils.flow_viz import flow_to_image


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1  # Castagnoli, reflected
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of data."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15, plus 0xa282ead8."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire format (the few fields an event file needs) --------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 two's complement, as protobuf encodes a negative
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(step: int, wall_time: float, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    """Event{wall_time = 1 (double), step = 2 (int64), file_version = 3,
    summary = 5}."""
    out = _key(1, 1) + struct.pack("<d", wall_time) + _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value{tag = 1, simple_value = 2 (float)}."""
    return _bytes_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)


def _image_value(tag: str, png: bytes, height: int, width: int) -> bytes:
    """Summary.Value{tag = 1, image = 4: Image{height = 1, width = 2,
    colorspace = 3 (3: RGB), encoded_image_string = 4}}."""
    image = (_key(1, 0) + _varint(height) + _key(2, 0) + _varint(width)
             + _key(3, 0) + _varint(3) + _bytes_field(4, png))
    return _bytes_field(1, tag.encode()) + _bytes_field(4, image)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def _to_uint8_rgb(image: np.ndarray) -> np.ndarray:
    """tensorboardX's conversion: uint8 as is, any other dtype taken as
    [0, 1] and scaled by 255, clipped and truncated."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"images are [H, W, 3], got {image.shape}")
    if image.dtype == np.uint8:
        return image
    return (image.astype(np.float32) * 255.0).clip(0, 255).astype(np.uint8)


class TensorBoardWriter:
    """Scalars and images into a TensorBoard event file under `log_dir`
    (`events.out.tfevents.<seconds>.<host>`), with flow-image helpers."""

    def __init__(self, log_dir: str = "runs"):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._file = open(self.path, "ab")
        self._file.write(_record(_event(0, now, file_version="brain.Event:2")))

    def _write(self, step: int, value: bytes) -> None:
        self._file.write(_record(_event(int(step), time.time(), summary=_bytes_field(1, value))))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(step, _scalar_value(tag, float(value)))

    def add_scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.add_scalar(prefix + k, float(v), step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image [H, W, 3]: uint8, or floats in [0, 1]."""
        img = _to_uint8_rgb(image)
        self._write(step, _image_value(tag, encode_png(img), img.shape[0], img.shape[1]))

    def add_flow_image(self, tag: str, flow: np.ndarray, step: int) -> None:
        """flow [H, W, 2] as its Middlebury colour-wheel image."""
        self.add_image(tag, flow_to_image(np.asarray(flow)), step)

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()


def _parse(buf: bytes) -> Dict[int, list]:
    """One protobuf message's fields: {field: [value, ...]}; varints as
    ints, 64-bit and 32-bit fields as bytes, length-delimited as bytes."""
    fields: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(v)
    return fields


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def read_event_file(path: str) -> List[Dict]:
    """The events of a file `TensorBoardWriter` wrote, each CRC checked
    (ValueError on a mismatch or a cut record): [{"wall_time", "step",
    "file_version" or "values": [{"tag", "simple_value" or "image":
    {"height", "width", "colorspace", "pixels"}}]}]."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        if i + 12 > len(data):
            raise ValueError(f"{path}: a cut record at byte {i}")
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        if struct.unpack("<I", data[i + 8:i + 12])[0] != masked_crc32c(header):
            raise ValueError(f"{path}: length CRC mismatch at byte {i}")
        payload = data[i + 12:i + 12 + n]
        crc = data[i + 12 + n:i + 16 + n]
        if len(payload) != n or len(crc) != 4:
            raise ValueError(f"{path}: a cut record at byte {i}")
        if struct.unpack("<I", crc)[0] != masked_crc32c(payload):
            raise ValueError(f"{path}: payload CRC mismatch at byte {i}")
        i += 16 + n
        ev = _parse(payload)
        out = {"wall_time": struct.unpack("<d", ev[1][0])[0], "step": ev.get(2, [0])[0]}
        if 3 in ev:
            out["file_version"] = ev[3][0].decode()
        for summary in ev.get(5, []):
            out["values"] = []
            for raw in _parse(summary).get(1, []):
                val = _parse(raw)
                entry = {"tag": val[1][0].decode()}
                if 2 in val:
                    entry["simple_value"] = struct.unpack("<f", val[2][0])[0]
                if 4 in val:
                    img = _parse(val[4][0])
                    entry["image"] = {"height": img[1][0], "width": img[2][0],
                                      "colorspace": img[3][0], "pixels": decode_png(img[4][0])}
                out["values"].append(entry)
        events.append(out)
    return events


def save_flow_grid(path: str, panels: Sequence[np.ndarray], ncols: int = 3,
                   titles: Optional[Sequence[str]] = None) -> str:
    """One PNG of panels tiled row by row, `ncols` a row: [H, W, 2] flows
    as their colour-wheel images, [H, W, 3] images as they are (0-255, or
    0-1 when their largest value is at most 1.5, as the JAX package reads
    them). Cells are the largest panel's size, white around smaller panels.

    The JAX package draws the grid with matplotlib, titles above the
    panels. The port draws no text: the titles, with each panel's cell
    (row, column), go beside the PNG in a `.json` of the same stem.
    """
    imgs = []
    for p in panels:
        p = np.asarray(p)
        if p.shape[-1] == 2:
            imgs.append(flow_to_image(p))
        else:
            imgs.append((p if p.max() > 1.5 else p * 255.0).astype(np.uint8))
    ch = max(i.shape[0] for i in imgs)
    cw = max(i.shape[1] for i in imgs)
    nrows = (len(imgs) + ncols - 1) // ncols
    grid = np.full((nrows * ch, ncols * cw, 3), 255, np.uint8)
    cells = []
    for k, img in enumerate(imgs):
        r, c = divmod(k, ncols)
        grid[r * ch:r * ch + img.shape[0], c * cw:c * cw + img.shape[1]] = img[..., :3]
        cells.append([r, c])
    with open(path, "wb") as f:
        f.write(encode_png(grid))
    meta = {"titles": list(titles or []), "cells": cells, "cell_hw": [ch, cw], "ncols": ncols}
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(meta, f)
    return path


class TeeLogger:
    """Duplicate stdout to a timestamped log file (`train_liteflownet3.py:32-77`)."""

    def __init__(self, log_dir: str = "logs", name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(log_dir, f"{name}_{stamp}.log")
        self._file = open(self.path, "a")
        self._stdout = sys.stdout

    def write(self, msg: str):
        self._stdout.write(msg)
        self._file.write(msg)
        self._file.flush()

    def flush(self):
        self._stdout.flush()
        self._file.flush()

    def __enter__(self):
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._stdout
        self._file.close()
        return False
