"""mfu.serve: the model's FLOPs per call (flowbench/flops.py) times the calls
of the unprofiled window per second, over the policy's peak, in %."""

from flowbench.peaks import PEAK_FLOPS


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    return 100.0 * rec.work_flops * rec.attempted / rec.window_s / PEAK_FLOPS[rec.policy]
