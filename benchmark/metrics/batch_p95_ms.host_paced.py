"""95th percentile of the window's batch times, from a client's call into
the entry to its top-k on the host, over every batch served. A per-layer
metric because the host paces the batches in these cells: in the API cell
the card idles most of the window; in the headline cell it is busy about
half of it, but a batch waits on the host's planner and enqueue, and the
tail's spread from run to run is wider than any bound a check may hold
(PERF.md, section 2)."""

import statistics


def read(run):
    ms = [(s.t1 - s.t0) / 1e6 for s in run.served]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[-1]
