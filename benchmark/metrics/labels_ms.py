"""Mean over the window's batches of the host ms in the batch's
`map.labels` spans (0 where it met no new class): the index upload, the
pull of the new classes' label block and a tuple a row.  A mean, since
the first batches of a pass carry nearly all of it.  None where the
port keeps no such records."""

import statistics

from benchmark.foldrecs import span_ms


def read(run):
    ms = span_ms(run, "map.labels")
    return statistics.mean(ms) if ms else None
