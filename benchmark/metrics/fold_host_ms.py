"""Median over the window's batches of the host ms in the batch's
`map.fold_host` spans: `add_hashed` over the batch's classes and
`register_new` for the new ones (sailfish_tpu_torch/eqclass/classes.py).
None where the port keeps no such records."""

import statistics

from benchmark.foldrecs import span_ms


def read(run):
    ms = span_ms(run, "map.fold_host")
    return statistics.median(ms) if ms else None
