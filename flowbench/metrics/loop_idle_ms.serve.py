"""loop_idle_ms.serve: device-idle ms per call inside the GRU loop's device
extent. For each of the program's `raft.loop` spans, the extent runs from
the start of the first kernel launched inside it (a kernel is tied to its
launch by the profiler's correlation id) to the end of the last; its idle
time is what no device operation (kernel, copy or set, merged) covers.
Measured on the device's timeline, since the host runs ahead of the device:
what the loop's launches cost, which a CUDA graph of the iteration would
remove. Nothing to read where the program opens no such span."""

import bisect

from flowbench import stats

SPAN = "raft.loop"


def _interval(e):
    t = float(e["ts"]) * 1e-6
    return t, t + float(e["dur"]) * 1e-6


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    tr = rec.trace
    loops = sorted(_interval(e) for e in tr.host
                   if e.get("cat") == "user_annotation" and e.get("name") == SPAN)
    if not loops:
        return None
    launched = {}
    for e in tr.host:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launched[corr] = float(e["ts"]) * 1e-6
    starts = [lo for lo, _ in loops]
    extents = {}
    for k in tr.kernels:
        t = launched.get((k.get("args") or {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= loops[i][1]:
            continue
        k0, k1 = _interval(k)
        lo, hi = extents.get(i, (k0, k1))
        extents[i] = (min(lo, k0), max(hi, k1))
    if not extents:
        return None
    device = [_interval(e) for e in tr.device]
    idle = sum(hi - lo - stats.busy(device, lo, hi) for lo, hi in extents.values())
    return 1e3 * idle / rec.profiled
