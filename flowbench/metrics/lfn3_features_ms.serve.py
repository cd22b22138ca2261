"""lfn3_features_ms.serve: device ms per call of the kernels launched inside
the program's `lfn3.features` spans (the mean offsets, the rescale to
multiples of 32, the feature extractor on both frames and the image pyramid,
models/liteflownet3.py; one a call). A kernel is tied to its launch by the
profiler's correlation id, so kernels that run after their span has closed
on the host count. Nothing to read where the program opens no such span."""

SPAN = "lfn3.features"


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    s = rec.trace.kernel_s_in_range(SPAN)
    return None if s is None else 1e3 * s / rec.profiled
