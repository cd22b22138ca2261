"""launches.train: kernels launched per step in the profiled stretch."""


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.profiled:
        return None
    return rec.trace.launches() / rec.profiled
