"""mfu.train: the training step's FLOPs (3x the forward, flowbench/flops.py)
times the unprofiled window's steps per second, over the policy's peak of
every card the step runs on, in %."""

from flowbench.peaks import PEAK_FLOPS


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    peak = PEAK_FLOPS[rec.policy] * rec.world
    return 100.0 * rec.work_flops * rec.attempted / rec.window_s / peak
