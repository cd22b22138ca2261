"""lfn3_warp_ms.serve: device ms per call of the kernels launched inside the
program's `lfn3.warp` spans (models/liteflownet3.py::_warp,
ops/warp.py::warp_lfn3, of features, flows and images; thirteen a call). A
kernel is tied to its launch by the profiler's correlation id, so kernels
that run after their span has closed on the host count. Nothing to read
where the program opens no such span."""

SPAN = "lfn3.warp"


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    s = rec.trace.kernel_s_in_range(SPAN)
    return None if s is None else 1e3 * s / rec.profiled
