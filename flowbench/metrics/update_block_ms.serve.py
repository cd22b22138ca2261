"""update_block_ms.serve: device ms per call of the kernels launched inside
the update block's calls (host ranges that forward hooks open and close in
the traced run only; a kernel is tied to its launch by the profiler's
correlation id)."""

UPDATE_RANGE = "flowbench.update_block"


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    s = rec.trace.kernel_s_in_range(UPDATE_RANGE)
    return None if not s else 1e3 * s / rec.profiled
