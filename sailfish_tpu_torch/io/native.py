"""ctypes loader for the native C++ host helpers (SA-IS suffix array
construction and the FASTQ decoder).

Counterpart of sailfish_tpu/io/native.py.  The shared library is built
from csrc/host/ with g++ at first use (see _ext.py) into _build/; the
port loads no binary from elsewhere.  Without g++ or zlib the functions
here return None and their callers take the pure-numpy fallbacks (host
code only: no device and no kernel hides behind them); the reason is
logged once.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional

import numpy as np

from .._ext import host_library_path

log = logging.getLogger("sailfish_tpu_torch")

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(host_library_path()))
    except (RuntimeError, OSError) as e:
        log.warning("native host helpers unavailable, using the numpy "
                    "fallbacks: %s", str(e).splitlines()[0])
        return None
    # int64 sf_fastq_open(const char* path)
    lib.sf_fastq_open.argtypes = [ctypes.c_char_p]
    lib.sf_fastq_open.restype = ctypes.c_int64
    # int64 sf_fastq_next_batch(handle, uint8* codes, int32* lens,
    #                           int64 batch, int64 maxlen) -> nreads (0=eof)
    lib.sf_fastq_next_batch.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.sf_fastq_next_batch.restype = ctypes.c_int64
    lib.sf_fastq_close.argtypes = [ctypes.c_int64]
    lib.sf_fastq_close.restype = None
    lib.sf_fastq_skip.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.sf_fastq_skip.restype = ctypes.c_int64
    # suffix array: int32 sf_build_sa(const uint8* text, int64 n, int32* sa)
    lib.sf_build_sa.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sf_build_sa.restype = ctypes.c_int32
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _lib() is not None


def native_sais_available() -> bool:
    """Whether `index` builds the suffix array with the native SA-IS
    rather than the numpy prefix doubling."""
    return _lib() is not None


class NativeFastqReader:
    """Stateful handle over the C++ decoder: next_batch() decodes into a
    fresh FastqBatch; skip(n) fast-forwards n records WITHOUT decoding
    or encoding (the shard-aware IO path: other shards' batches cost one
    line scan, not a parse+encode).  Raises IOError on malformed records
    (instead of treating them as EOF)."""

    def __init__(self, lib, handle, path, batch_size, max_len):
        self._lib = lib
        self._h = handle
        self.path = path
        self.batch_size = batch_size
        self.max_len = max_len

    def next_batch(self):
        from .fastq import FastqBatch

        if self._h is None:
            return None
        codes = np.empty((self.batch_size, self.max_len), dtype=np.uint8)
        lens = np.empty(self.batch_size, dtype=np.int32)
        n = self._lib.sf_fastq_next_batch(
            self._h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.batch_size,
            self.max_len,
        )
        if n < 0:
            raise IOError(f"malformed FASTQ record in {self.path}")
        if n == 0:
            return None
        return FastqBatch(codes=codes[:n], lens=lens[:n])

    def skip(self, count: int) -> int:
        """Skip up to `count` records; returns the number skipped."""
        if self._h is None or count <= 0:
            return 0
        got = self._lib.sf_fastq_skip(self._h, count)
        if got < 0:
            raise IOError(f"malformed FASTQ record in {self.path}")
        return int(got)

    def close(self):
        if self._h is not None:
            self._lib.sf_fastq_close(self._h)
            self._h = None


def native_open_fastq(path: str, batch_size: int, max_len: int,
                      skip_reads: int = 0) -> Optional[NativeFastqReader]:
    """NativeFastqReader positioned after `skip_reads` records, or None
    if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    handle = lib.sf_fastq_open(path.encode())
    if handle < 0:
        raise IOError(f"native fastq open failed: {path}")
    rd = NativeFastqReader(lib, handle, path, batch_size, max_len)
    if skip_reads:
        got = rd.skip(skip_reads)
        if got != skip_reads:
            rd.close()
            raise IOError(
                f"{path}: cannot skip {skip_reads} reads "
                f"(file has only {got})"
            )
    return rd


def native_build_sa(text: np.ndarray) -> Optional[np.ndarray]:
    """SA-IS suffix array via C++, or None if unavailable.

    `text` is uint8 codes (values < 250); returns int32 suffix array of
    len(text) entries.
    """
    lib = _lib()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(text), dtype=np.int32)
    rc = lib.sf_build_sa(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(text),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        return None
    return sa
