"""Host-side FASTA reading (transcriptome loader).

Replaces the reference's jellyfish-based FASTA path
(src/SailfishQuantify.cpp:62-64 aliases); output feeds the index builder.
Supports plain and gzip files.
"""

from __future__ import annotations

import gzip

import numpy as np

from .. import dna


def _open_maybe_gz(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 20)


def read_fasta(path: str) -> tuple[list[str], list[np.ndarray]]:
    """Read a FASTA file into (names, code arrays).

    Names are the first whitespace-delimited token of each header (the
    reference uses the full RapMap record name; RapMap itself keys on the
    token).  Sequences are uint8 code arrays (dna.encode).
    """
    names: list[str] = []
    seqs: list[np.ndarray] = []
    chunks: list[bytes] = []

    def flush():
        if names:
            seqs.append(dna.encode(b"".join(chunks)))
            chunks.clear()

    with _open_maybe_gz(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                flush()
                names.append(line[1:].split()[0].decode("ascii"))
            else:
                chunks.append(line)
        flush()
    if len(seqs) != len(names):
        raise ValueError(f"malformed FASTA: {path}")
    return names, seqs
