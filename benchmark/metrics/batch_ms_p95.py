"""95th percentile of the window's fold-to-fold ms (the first from the
window's start), the one-deep loop's time a batch."""

import statistics


def read(run):
    ms = run.counters.get("batch_ms", [])
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
