"""Median over the window's batches of the distinct eq classes the
batch's fold pulled (the port's counter `map.fold_classes`).  None where
the port does not count them."""

import statistics

from benchmark.foldrecs import counts


def read(run):
    n = counts(run, "map.fold_classes")
    return statistics.median(n) if n else None
