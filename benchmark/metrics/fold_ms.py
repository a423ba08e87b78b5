"""Median host ms of `finish_batch_fast` a batch in the window: the pull
of the batch's counters and classes and the host eq-class fold (the
benchmark's span)."""

import statistics


def read(run):
    ms = run.spans.ms("fold")
    return statistics.median(ms) if ms else None
