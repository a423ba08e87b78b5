"""DNA alphabet codecs shared by the host and device paths.

Encoding: A=0, C=1, G=2, T/U=3 (2-bit), SEP=4 (transcript separator /
invalid base).  Reads never contain SEP, so a SEP in the concatenated
transcriptome text can never match a read base — matches terminate at
transcript boundaries for free.

The 2-bit k-mer index convention matches the reference codec
(reference: include/UtilityFunctions.hpp:89-145): the base at the
*smallest* position occupies the *most significant* bits, so integer
comparison of packed words is lexicographic comparison of the bases.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
SEP = 4  # transcript separator / any non-ACGT input base

# byte -> code lookup (np.uint8 indexed); non-ACGT maps to SEP
_BYTE_TO_CODE = np.full(256, SEP, dtype=np.uint8)
for _ch, _code in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _BYTE_TO_CODE[ord(_ch)] = _code
    _BYTE_TO_CODE[ord(_ch.lower())] = _code

_CODE_TO_BYTE = np.frombuffer(b"ACGT$", dtype=np.uint8).copy()

# complement of a code; SEP maps to itself
_COMP = np.array([T, G, C, A, SEP], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3, SEP for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _BYTE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (SEP renders as '$')."""
    return _CODE_TO_BYTE[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (SEP stays SEP)."""
    return _COMP[np.asarray(codes)][::-1]


def kmer_index(codes: np.ndarray, k: int) -> int:
    """2-bit index of a single k-mer, earliest base most significant.

    Mirrors reference indexForKmer(..., Direction::FORWARD)
    (include/UtilityFunctions.hpp:89-121).  Returns -1 if any base is
    invalid (reference returns uint32 max).
    """
    codes = np.asarray(codes[:k], dtype=np.int64)
    if np.any(codes >= 4):
        return -1
    idx = 0
    for c in codes:
        idx = (idx << 2) | int(c)
    return idx


def kmer_index_rc(codes: np.ndarray, k: int) -> int:
    """2-bit index of the reverse complement of a k-mer.

    Mirrors reference indexForKmer(..., Direction::REVERSE_COMPLEMENT)
    (include/UtilityFunctions.hpp:122-143).
    """
    codes = np.asarray(codes[:k])
    if np.any(codes >= 4):
        return -1
    return kmer_index(revcomp(codes), k)


def kmer_for_index(idx: int, k: int) -> str:
    """Inverse of kmer_index (reference kmerForIndex,
    include/UtilityFunctions.hpp:12-38)."""
    out = []
    for i in range(k):
        out.append("ACGT"[(idx >> (2 * (k - 1 - i))) & 0x3])
    return "".join(out)


def next_kmer_index(idx: int, new_base: int, k: int, rc: bool = False) -> int:
    """Rolling k-mer update: shift in new_base at the low end.

    Mirrors reference nextKmerIndex (include/UtilityFunctions.hpp:40-86):
    shift left by 2, add the (complemented, if rc) incoming base, mask to
    2k bits.
    """
    base = int(new_base)
    if rc:
        base = int(_COMP[base])
    mask = (1 << (2 * k)) - 1
    return ((idx << 2) | base) & mask


def rolling_kmer_indices(codes: np.ndarray, k: int) -> np.ndarray:
    """Vectorized 2-bit indices for every k-mer of `codes`.

    Returns int64[len(codes)-k+1]; positions whose window contains an
    invalid base get -1.
    """
    codes = np.asarray(codes, dtype=np.int64)
    n = len(codes) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    # sliding windows without copying everything k times for big k is
    # fine here: k <= 32 and this is a host-side helper.
    win = np.lib.stride_tricks.sliding_window_view(codes, k)
    idx = (win * weights).sum(axis=1)
    bad = (win >= 4).any(axis=1)
    idx[bad] = -1
    return idx


def pack_words_u32(
    codes: np.ndarray, bases_per_word: int = 16, sub: int = 0
) -> np.ndarray:
    """Pack codes into big-endian-ish 2-bit words for lexicographic compare.

    word[p] packs codes[p : p + bases_per_word] with the base at p in the
    most significant bits, SEP/invalid packed as 0 (A).  Positions past the
    end behave as if padded with 0.  uint32 holds 16 bases.

    Integer comparison of word[p] values therefore orders suffixes by
    their first 16 bases *under the A-substituted text* — which is the
    ordering the suffix array in index/builder.py is built with.
    """
    assert bases_per_word * 2 <= 32
    n = len(codes)
    if bases_per_word != 16:
        c = np.asarray(codes, dtype=np.uint64)
        c = np.where(c >= 4, sub, c)
        padded = np.zeros(n + bases_per_word, dtype=np.uint64)
        padded[:n] = c
        out = np.zeros(n, dtype=np.uint64)
        for j in range(bases_per_word):
            out |= padded[j : j + n] << np.uint64(
                2 * (bases_per_word - 1 - j))
        return out.astype(np.uint32)
    # 16-base fast path: pack ALIGNED words with byte-wide folds (MSB
    # first), then derive every sliding word with one funnel shift per
    # residue — ~10x less memory traffic than 16 shifted u64 passes
    m = -(-n // 16) + 2                 # aligned words incl. zero pad
    b2 = np.zeros(m * 16, np.uint8)
    cc = np.asarray(codes, np.uint8)
    b2[:n] = np.where(cc >= 4, np.uint8(sub), cc)
    t = (b2[0::2] << 2) | b2[1::2]      # 2 bases/byte, first base high
    t = (t[0::2] << 4) | t[1::2]        # 4 bases/byte
    al = np.ascontiguousarray(t).view("<u4").byteswap()  # MSB-first u32
    out = np.empty(n, dtype=np.uint32)
    for r in range(16):
        seg = out[r::16]
        k = len(seg)
        if r == 0:
            seg[:] = al[:k]
        else:
            np.bitwise_or(
                al[:k] << np.uint32(2 * r),
                al[1 : k + 1] >> np.uint32(32 - 2 * r),
                out=seg,
            )
    return out
