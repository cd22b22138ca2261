"""train_pairs_per_s: global pairs trained in the window over the window,
which ends at a synchronize after its last step."""

from flowbench import stats


def read(rec):
    if rec.kind != "train":
        return None
    return stats.rate(rec.attempted * rec.global_batch, rec.window_s)
