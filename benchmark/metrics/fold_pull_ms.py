"""Median over the window's batches of the host ms in the batch's
`map.pull` spans: the pull of its counters and unique classes, the
waits included (sailfish_tpu_torch/map/pipeline.py `_fold`).  None
where the port keeps no such records."""

import statistics

from benchmark.foldrecs import span_ms


def read(run):
    ms = span_ms(run, "map.pull")
    return statistics.median(ms) if ms else None
