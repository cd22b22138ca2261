"""lfn3_smooth_ms.serve: device ms per call of the kernels launched inside the
program's `lfn3.smooth` spans (models/liteflownet3.py::_distance_smooth: the
distance softmax and the weighted sum over each k x k neighbourhood; four a
call). A kernel is tied to its launch by the profiler's correlation id, so
kernels that run after their span has closed on the host count. Nothing to
read where the program opens no such span."""

SPAN = "lfn3.smooth"


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    s = rec.trace.kernel_s_in_range(SPAN)
    return None if s is None else 1e3 * s / rec.profiled
