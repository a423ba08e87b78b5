"""Host-side FASTQ streaming into fixed-shape device batches.

Counterpart of sailfish_tpu/io/fastq.py.  The reference streams
1000-read jobs through jellyfish parser threads
(src/SailfishQuantify.cpp:73,893-899).  Here the reader produces large
fixed-shape uint8 batches (padded to one read width) so the whole batch
maps in one pass on the device; a background thread double-buffers
decode against device compute.

A native C++ decoder (csrc/host/fastq_decode.cpp, loaded via ctypes) is
used when available; the numpy fallback is pure Python + vectorized numpy.

Read length handling: the static batch width starts from a probe of the
file's first reads, but is NOT trusted as a bound.  Decoders report true
read lengths; when a longer read appears mid-file the stream restarts
from that read with a wider static width (a re-pad: one extra decode pass
over the already-consumed prefix) instead of silently truncating.
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
import threading
import queue as _queue
from typing import Iterator

import numpy as np

from .. import dna
from .native import native_open_fastq

log = logging.getLogger("sailfish_tpu_torch")


@dataclasses.dataclass
class FastqBatch:
    """A fixed-shape batch of encoded reads.

    codes:  uint8[n, max_len]  (0..3; SEP=4 padding / N bases)
    lens:   int32[n]           true read lengths
    count:  number of valid reads (n rows are all valid; the *device*
            batch may later be padded to batch_size with count tracking)
    """

    codes: np.ndarray
    lens: np.ndarray

    @property
    def count(self) -> int:
        return int(self.codes.shape[0])


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 22)


def sniff_read_format(path: str) -> str:
    """'fastq' or 'fasta' from the first non-blank byte — the reference
    accepts both read formats through jellyfish's whole_sequence_parser
    (src/SailfishQuantify.cpp:62-64)."""
    with _open_maybe_gz(path) as fh:
        while True:
            line = fh.readline()
            if not line:
                return "fastq"  # empty file: arbitrary, parses to 0 reads
            s = line.strip()
            if not s:
                continue
            if s.startswith(b">"):
                return "fasta"
            if s.startswith(b"@"):
                return "fastq"
            raise IOError(
                f"{path}: not FASTA or FASTQ (first record starts "
                f"with {s[:1]!r})"
            )


def _iter_fastq_seq_blocks(
    path: str, reads_per_block: int, skip_reads: int = 0
) -> Iterator[list[bytes]]:
    """Yield lists of raw sequence lines (bytes, no newline); accepts
    FASTQ or (multi-line) FASTA read files."""
    block: list[bytes] = []
    to_skip = skip_reads
    fasta = sniff_read_format(path) == "fasta"
    with _open_maybe_gz(path) as fh:
        if fasta:
            seq_parts: list[bytes] = []
            started = False

            def records():
                nonlocal seq_parts, started
                for line in fh:
                    s = line.rstrip()
                    if not s:
                        continue
                    if s.startswith(b">"):
                        if started:
                            yield b"".join(seq_parts)
                        seq_parts = []
                        started = True
                    else:
                        seq_parts.append(s)
                if started:
                    yield b"".join(seq_parts)

            record_iter = records()
        else:
            def records():
                while True:
                    header = fh.readline()
                    if not header:
                        return
                    if header.strip() == b"":
                        continue
                    if not header.startswith(b"@"):
                        raise IOError(f"malformed FASTQ record in {path}")
                    seq = fh.readline().rstrip()
                    fh.readline()  # '+'
                    fh.readline()  # quals
                    yield seq

            record_iter = records()
        for seq in record_iter:
            if to_skip > 0:
                to_skip -= 1
                continue
            block.append(seq)
            if len(block) >= reads_per_block:
                yield block
                block = []
    if to_skip > 0:
        raise IOError(
            f"{path}: cannot skip {skip_reads} reads "
            f"(file has only {skip_reads - to_skip})"
        )
    if block:
        yield block


def _encode_block(block: list[bytes], max_len: int) -> FastqBatch:
    """Encode raw sequences into a fixed-width batch.  `lens` carries the
    TRUE lengths (possibly > max_len) so the caller can detect overflow;
    codes are clipped to the batch width."""
    n = len(block)
    true_lens = np.fromiter((len(s) for s in block), dtype=np.int32, count=n)
    clipped = np.minimum(true_lens, max_len)
    joined = b"".join(s[:max_len] for s in block)
    flat = dna.encode(joined)
    codes = np.full((n, max_len), dna.SEP, dtype=np.uint8)
    # scatter via split positions
    ends = np.cumsum(clipped)
    starts = ends - clipped
    # vectorized ragged copy: build row/col index arrays
    total = int(ends[-1]) if n else 0
    if total:
        rows = np.repeat(np.arange(n), clipped)
        cols = np.arange(total) - np.repeat(starts, clipped)
        codes[rows, cols] = flat
    return FastqBatch(codes=codes, lens=true_lens)


def round_up_len(n: int) -> int:
    return max(8, (int(n) + 7) // 8 * 8)


class _PyFastqReader:
    """Pure-Python reader with the same next_batch/skip interface as
    io.native.NativeFastqReader (the fallback when the native library
    is absent, and the only reader for FASTA-format reads).  skip() reads
    record lines without parsing or encoding."""

    def __init__(self, path, batch_size, max_len, skip_reads=0):
        self.path = path
        self.batch_size = batch_size
        self.max_len = max_len
        self._fasta = sniff_read_format(path) == "fasta"
        self._pending_header = False  # FASTA: '>' line already consumed
        self._fh = _open_maybe_gz(path)
        if skip_reads:
            got = self.skip(skip_reads)
            if got != skip_reads:
                self.close()
                raise IOError(
                    f"{path}: cannot skip {skip_reads} reads "
                    f"(file has only {got})"
                )

    def _next_seq(self) -> bytes | None:
        fh = self._fh
        if self._fasta:
            # position invariant: just before a record's '>' header
            # unless _pending_header (header consumed by the previous
            # record's lookahead)
            if not self._pending_header:
                while True:
                    header = fh.readline()
                    if not header:
                        return None
                    s = header.strip()
                    if not s:
                        continue
                    if not s.startswith(b">"):
                        raise IOError(
                            f"malformed FASTA record in {self.path}"
                        )
                    break
            self._pending_header = False
            parts: list[bytes] = []
            while True:
                line = fh.readline()
                if not line:
                    break
                s = line.rstrip()
                if not s:
                    continue
                if s.startswith(b">"):
                    self._pending_header = True
                    break
                parts.append(s)
            return b"".join(parts)
        while True:
            header = fh.readline()
            if not header:
                return None
            if header.strip() == b"":
                continue
            if not header.startswith(b"@"):
                raise IOError(f"malformed FASTQ record in {self.path}")
            seq = fh.readline().rstrip()
            fh.readline()  # '+'
            fh.readline()  # quals
            return seq

    def next_batch(self) -> "FastqBatch | None":
        block: list[bytes] = []
        while len(block) < self.batch_size:
            s = self._next_seq()
            if s is None:
                break
            block.append(s)
        if not block:
            return None
        return _encode_block(block, self.max_len)

    def skip(self, count: int) -> int:
        n = 0
        while n < count:
            if self._next_seq() is None:
                break
            n += 1
        return n

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _open_reader(path, batch_size, max_len, skip_reads, use_native):
    rd = None
    # the native C++ decoder parses FASTQ only; FASTA reads take the
    # Python reader
    if use_native and sniff_read_format(path) == "fastq":
        rd = native_open_fastq(path, batch_size, max_len, skip_reads)
    if rd is None:
        rd = _PyFastqReader(path, batch_size, max_len, skip_reads)
    return rd


class _RepadDecoder:
    """Batch stream over one file whose static width can grow: when a
    read longer than the current max_len appears, the stream restarts
    from that read's position with a wider width (the already-yielded
    prefix was unaffected — every read in it fit the old width).

    `yielded` counts records CONSUMED (decoded or skipped), so restart
    resumes at the right file position under shard-skipping too."""

    def __init__(self, path, batch_size, max_len, use_native=True):
        self.path = path
        self.batch_size = batch_size
        self.max_len = max_len
        self.use_native = use_native
        self.yielded = 0
        self._rd = _open_reader(path, batch_size, max_len, 0, use_native)

    def next_batch(self) -> FastqBatch | None:
        """Next batch, or None at EOF.  The returned batch may carry
        lens > max_len — the caller decides when/how to restart (for
        paired files both mates restart together)."""
        return self._rd.next_batch()

    def skip_batch(self) -> int:
        """Fast-forward one batch's worth of records without decoding
        (shard-aware IO: other shards' batches cost a line scan, not a
        parse+encode+map).  Returns records skipped (0 at EOF)."""
        n = self._rd.skip(self.batch_size)
        self.yielded += n
        return n

    def overflow(self, b: FastqBatch) -> int:
        m = int(b.lens.max()) if b.count else 0
        return m if m > self.max_len else 0

    def restart(self, new_max_len: int):
        """Re-open at the current position with a wider static width.
        The pending (overflowed) batch is re-decoded on the next call."""
        self._rd.close()
        self.max_len = new_max_len
        self._rd = _open_reader(
            self.path, self.batch_size, new_max_len, self.yielded,
            self.use_native,
        )

    def advance(self, b: FastqBatch):
        self.yielded += b.count

    def close(self):
        self._rd.close()


def _run_producer(q: _queue.Queue, fn):
    """Run fn (which puts batches on q) and propagate any exception to
    the consumer instead of letting a daemon thread die silently."""
    try:
        fn()
        q.put(None)
    except BaseException as e:  # noqa: BLE001 - re-raised in consumer
        q.put(e)


def _consume(q: _queue.Queue):
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        yield item


def iter_fastq_batches(
    path: str, batch_size: int, max_len: int, prefetch: int = 2,
    use_native: bool = True, shard: tuple[int, int] = (0, 1),
) -> Iterator[FastqBatch]:
    """Stream single-end batches with background decode.

    `shard=(sid, n)` yields only batches whose index ≡ sid (mod n);
    the others are fast-forwarded with a line scan (no parse/encode) —
    the shard-aware IO half of the multi-host path (SURVEY §2.4)."""
    sid, nshards = shard

    def produce():
        dec = _RepadDecoder(path, batch_size, max_len, use_native)
        batch_idx = 0
        try:
            while True:
                if nshards > 1 and (batch_idx % nshards) != sid:
                    if dec.skip_batch() == 0:
                        break
                    batch_idx += 1
                    continue
                b = dec.next_batch()
                if b is None:
                    break
                over = dec.overflow(b)
                if over:
                    new_len = round_up_len(over)
                    log.warning(
                        "%s: read of length %d exceeds batch width %d at "
                        "read %d; re-padding to %d (re-decoding prefix)",
                        path, over, dec.max_len, dec.yielded, new_len,
                    )
                    dec.restart(new_len)
                    continue
                dec.advance(b)
                batch_idx += 1
                q.put(b)
        finally:
            dec.close()

    q: _queue.Queue = _queue.Queue(maxsize=prefetch)
    t = threading.Thread(
        target=_run_producer, args=(q, produce), daemon=True
    )
    t.start()
    yield from _consume(q)


def iter_paired_fastq_batches(
    path1: str, path2: str, batch_size: int, max_len: int, prefetch: int = 2,
    use_native: bool = True, shard: tuple[int, int] = (0, 1),
    decode_threads: int = 1,
) -> Iterator[tuple[FastqBatch, FastqBatch]]:
    """Stream paired-end batches (mate1, mate2) with background decode.
    Both mates share one static width; a long read in either file
    restarts both streams at the same fragment position.

    `shard=(sid, n)`: yield only batch indices ≡ sid (mod n), skipping
    the rest without decoding.  `decode_threads >= 2` decodes the two
    mate files concurrently (the -p/--numThreads CLI knob)."""
    sid, nshards = shard

    def produce():
        d1 = _RepadDecoder(path1, batch_size, max_len, use_native)
        d2 = _RepadDecoder(path2, batch_size, max_len, use_native)
        pool = None
        if decode_threads >= 2:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=2)

        def both(f1, f2):
            if pool is not None:
                a1 = pool.submit(f1)
                a2 = pool.submit(f2)
                return a1.result(), a2.result()
            return f1(), f2()

        batch_idx = 0
        try:
            while True:
                if nshards > 1 and (batch_idx % nshards) != sid:
                    n1, n2 = both(d1.skip_batch, d2.skip_batch)
                    if n1 != n2:
                        raise ValueError(
                            "paired FASTQ files have different read counts "
                            f"({path1} vs {path2})"
                        )
                    if n1 == 0:
                        break
                    batch_idx += 1
                    continue
                b1, b2 = both(d1.next_batch, d2.next_batch)
                if b1 is None and b2 is None:
                    break
                if b1 is None or b2 is None or b1.count != b2.count:
                    raise ValueError(
                        "paired FASTQ files have different read counts "
                        f"({path1} vs {path2})"
                    )
                over = max(d1.overflow(b1), d2.overflow(b2))
                if over:
                    new_len = round_up_len(over)
                    log.warning(
                        "read of length %d exceeds batch width %d at "
                        "fragment %d; re-padding to %d (re-decoding prefix)",
                        over, d1.max_len, d1.yielded, new_len,
                    )
                    d1.restart(new_len)
                    d2.restart(new_len)
                    continue
                d1.advance(b1)
                d2.advance(b2)
                batch_idx += 1
                q.put((b1, b2))
        finally:
            d1.close()
            d2.close()
            if pool is not None:
                pool.shutdown(wait=False)

    q: _queue.Queue = _queue.Queue(maxsize=prefetch)
    t = threading.Thread(
        target=_run_producer, args=(q, produce), daemon=True
    )
    t.start()
    yield from _consume(q)
