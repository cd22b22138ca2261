"""idle_share.train: the share of the profiled stretch (rank 0's on several
cards) in which no device operation ran, in %: kernel, copy and set
intervals merged, not summed."""


def read(rec):
    if rec.kind != "train" or rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
