"""A profiled stretch and its reduction, from the profiler's Chrome trace.

`profile(fn)` runs fn (which ends in a device synchronize) once under
`torch.profiler` inside the range `flowbench.stretch`, exports the Chrome
trace to a temporary file under TMPDIR, reads it back and deletes it. The
reduction (`Trace`) works on the trace's events alone, so a canned trace
tests it:

  - device operations: events of category kernel, gpu_memcpy, gpu_memset;
    busy time is their intervals merged (overlaps count once) inside the
    stretch;
  - a kernel belongs to a host range (`record_function`) when the runtime
    call that launched it (the same `correlation` id) started inside it;
  - an idle gap is named by the innermost host operation of the stretch's
    thread running when the gap began ("(between host operations)" when
    none was).
Times are seconds.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Pattern, Tuple

from flowbench import stats

STRETCH = "flowbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def profile(fn: Callable[[], None]) -> List[dict]:
    """The trace events of one call of fn under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
    fd, path = tempfile.mkstemp(prefix="flowbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class Trace:
    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
        stretch = [e for e in xs if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
        if len(stretch) != 1:
            raise ValueError(f"expected one {STRETCH} range, found {len(stretch)}")
        s = stretch[0]
        self.lo = float(s["ts"]) * 1e-6
        self.hi = (float(s["ts"]) + float(s["dur"])) * 1e-6
        self._thread = (s.get("pid"), s.get("tid"))
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and self.lo <= float(e["ts"]) * 1e-6 < self.hi]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in xs if e.get("cat") in HOST_CATS and e is not s
                     and (e.get("pid"), e.get("tid")) == self._thread]
        self._launch_ts: Dict[int, float] = {}
        for e in xs:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self._launch_ts[corr] = float(e["ts"]) * 1e-6
        self._ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" and e.get("name") != STRETCH:
                t = float(e["ts"]) * 1e-6
                self._ranges[e["name"]].append((t, t + float(e["dur"]) * 1e-6))

    @staticmethod
    def _span(e: dict) -> Tuple[float, float]:
        t = float(e["ts"]) * 1e-6
        return t, t + float(e["dur"]) * 1e-6

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return stats.busy([self._span(e) for e in self.device], self.lo, self.hi)

    def kernel_s(self, pattern: Optional[Pattern] = None) -> float:
        """Summed device time of the kernels whose name matches."""
        return sum(float(e["dur"]) * 1e-6 for e in self.kernels
                   if pattern is None or pattern.search(e["name"]))

    def launches(self, pattern: Optional[Pattern] = None) -> int:
        return sum(1 for e in self.kernels if pattern is None or pattern.search(e["name"]))

    def kernel_s_in_range(self, name: str) -> Optional[float]:
        """Device time of the kernels launched inside the host ranges `name`;
        None when no kernel can be tied to its launch."""
        ranges = sorted(self._ranges.get(name, []))
        if not ranges:
            return None
        starts = [r[0] for r in ranges]
        total, linked = 0.0, 0
        for e in self.kernels:
            t = self._launch_ts.get((e.get("args") or {}).get("correlation"))
            if t is None:
                continue
            linked += 1
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ranges[i][1]:
                total += float(e["dur"]) * 1e-6
        return total if linked else None

    def top_device_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for e in self.device:
            by[e["name"]] += float(e["dur"]) * 1e-6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time of the stretch summed by the host operation that was
        running when each gap began; the n largest."""
        gaps = stats.gaps([self._span(e) for e in self.device], self.lo, self.hi)
        host = sorted((self._span(e) + (e["name"],) for e in self.host), key=lambda x: (x[0], -x[1]))
        by = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        i = 0
        for g0, g1 in gaps:
            while i < len(host) and host[i][0] <= g0:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] <= g0:
                stack.pop()
            by[stack[-1][2][:200] if stack else "(between host operations)"] += g1 - g0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
