"""lfn3_corr_roofline.serve: the least time of the profiled calls'
correlations (flowbench/lfn3_counts.py: each its bytes at HBM rate or its
operations at the policy's peak, whichever is longer) over the device time
of the kernels launched inside the program's `lfn3.corr` spans, in %.
Nothing to read where the program opens no such span."""

SPAN = "lfn3.corr"


def read(rec):
    bound = getattr(rec, "corr_bound_s", None)
    if rec.kind != "serve" or rec.trace is None or not bound:
        return None
    s = rec.trace.kernel_s_in_range(SPAN)
    return 100.0 * bound / s if s else None
