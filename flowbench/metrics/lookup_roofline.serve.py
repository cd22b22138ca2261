"""lookup_roofline.serve: the least time of the profiled calls' K1 and K2
launches (their bytes at HBM rate, flowbench/bytes.py) over their device
time, in %. K1 and K2 are the kernels named lookup_level_kernel,
coarse_fused_kernel and (their route for windows too wide for a block)
wide_lookup_kernel."""

import re

LOOKUP = re.compile(r"lookup_level_kernel|coarse_fused_kernel|wide_lookup_kernel")


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.lookup_bound_s:
        return None
    t = rec.trace.kernel_s(LOOKUP)
    return 100.0 * rec.lookup_bound_s / t if t > 0 else None
