"""serve_p90_ms: the 90th percentile (nearest rank) of every call's latency
in the window, from the call to the unpadded flow on the host."""

from flowbench import stats


def read(rec):
    if rec.kind != "serve" or not rec.latencies_s:
        return None
    return stats.percentile(rec.latencies_s, 90) * 1e3
