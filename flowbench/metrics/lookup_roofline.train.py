"""lookup_roofline.train: the least time of the profiled steps' K1 and K3
launches (flowbench/bytes.py) over their device time, in %. K1 is
lookup_level_kernel (wide_lookup_kernel for windows too wide for a block),
K3 lookup_level_bwd_kernel."""

import re

LOOKUP = re.compile(r"lookup_level_kernel|lookup_level_bwd_kernel|wide_lookup_kernel")


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.lookup_bound_s:
        return None
    t = rec.trace.kernel_s(LOOKUP)
    return 100.0 * rec.lookup_bound_s / t if t > 0 else None
