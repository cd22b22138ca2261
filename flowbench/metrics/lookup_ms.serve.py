"""lookup_ms.serve: device ms per call of the kernels launched inside the
program's `raft.lookup` spans (kernels/corr_lookup.py, K1 and K2, and their
glue; one a GRU iteration). A kernel is tied to its launch by the profiler's
correlation id, so kernels that run after their span has closed on the host
count. Nothing to read where the program opens no such span."""

SPAN = "raft.lookup"


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    s = rec.trace.kernel_s_in_range(SPAN)
    return None if s is None else 1e3 * s / rec.profiled
