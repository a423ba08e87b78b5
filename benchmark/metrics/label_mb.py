"""Mean over the window's batches of the MB of label block the batch's
fold pulled for its new classes (the port's counter `map.label_bytes`,
0 where it met none).  None where the port does not count the fold's
work."""

import statistics

from benchmark.foldrecs import counts


def read(run):
    b = counts(run, "map.label_bytes")
    return 1e-6 * statistics.mean(b) if b else None
