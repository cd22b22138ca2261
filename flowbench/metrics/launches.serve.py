"""launches.serve: kernels launched per call in the profiled stretch."""


def read(rec):
    if rec.kind != "serve" or rec.trace is None or not rec.profiled:
        return None
    return rec.trace.launches() / rec.profiled
