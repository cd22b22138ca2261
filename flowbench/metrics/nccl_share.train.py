"""nccl_share.train: NCCL kernels' device time over rank 0's device busy time
in the profiled steps, in %."""

import re

NCCL = re.compile(r"nccl", re.I)


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.world < 2:
        return None
    busy = rec.trace.busy_s
    t = rec.trace.kernel_s(NCCL)
    return 100.0 * t / busy if busy > 0 and t > 0 else None
