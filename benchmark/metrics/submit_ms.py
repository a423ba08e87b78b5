"""Median host ms of `submit_pe` a batch in the window: 2-bit pack, the
copy, and the device work queued (the benchmark's span)."""

import statistics


def read(run):
    ms = run.spans.ms("submit")
    return statistics.median(ms) if ms else None
