"""serve_pairs_per_s: every pair completed in the window over the window."""

from flowbench import stats


def read(rec):
    return stats.rate(rec.pairs, rec.window_s) if rec.kind == "serve" else None
