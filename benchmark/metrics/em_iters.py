"""Median iterations a solve in the window (`EMResult.num_iterations`)."""

import statistics


def read(run):
    its = run.counters.get("em_iters")
    return statistics.median(its) if its else None
