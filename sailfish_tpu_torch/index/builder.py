"""Quasi-mapping index: generalized suffix array over the concatenated
transcriptome + a k-mer-prefix interval table, laid out as flat arrays
ready for device upload.

Counterpart of sailfish_tpu/index/builder.py: the same arrays and the
same files on disk, so either package loads an index directory the other
wrote.  It replaces the reference's RapMap SA index (built via
libdivsufsort + a sparsehash k-mer table; see
include/SailfishIndex.hpp:21-156 and scripts/fetchRapMap.sh) with flat
arrays:

  text codes   uint8[N]   concatenated transcripts, SEP(4) after each
  sa           int32/64[N] suffix array over the A-substituted text
  packed16     uint32[N]  16-base 2-bit packed words (lexicographic)
  sep_dist     uint8[N]   distance to the next SEP (saturating) — caps
                          A-substituted LCPs at transcript boundaries
  table_lo     int32[4^P + 1] SA interval start per P-base prefix
  kmer table   open-addressing exact-k-mer -> SA-interval hash
                          (index/kmerhash.py), built when k >= 17
  txp_of_pos   int32[N]   position -> transcript id
  txp_offsets  int64[T], txp_lens int32[T], names

Ordering convention: the SA is sorted by the *A-substituted* text
(SEP packs as A) so that packed-word integer comparisons agree with SA
order exactly; candidate hits that straddle a transcript boundary are
eliminated later by LCP computation against the true codes (where SEP
matches nothing).  See dna.py.

The index is "64-bit" (big_sa) when N >= 2^31, mirroring the reference's
automatic 32/64-bit index selection (include/SailfishIndex.hpp:123-140).
Indexes striped into shards (`index --indexShards`) are not ported:
`load_index` refuses their directories.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .. import INDEX_VERSION, dna
from ..io.fasta import read_fasta
from ..io.native import native_build_sa
from .kmerhash import build_kmer_table, sep_distances


@dataclasses.dataclass
class QuasiIndex:
    k: int
    prefix_bases: int              # P
    names: list[str]
    codes: np.ndarray              # uint8[N] true codes (SEP=4)
    sa: np.ndarray                 # int32/int64[N]
    packed16: np.ndarray           # uint32[N], SEP packed as A (ordering)
    sep_dist: np.ndarray           # uint8[N]
    table_lo: np.ndarray           # int32/int64[4^P + 1]
    kmer_ht: dict | None           # device hash table (see kmerhash.py)
    txp_of_pos: np.ndarray         # int32[N]
    txp_offsets: np.ndarray        # int64[T]
    txp_lens: np.ndarray           # int32[T]

    @property
    def num_transcripts(self) -> int:
        return len(self.names)

    @property
    def text_len(self) -> int:
        return int(self.codes.shape[0])

    @property
    def big_sa(self) -> bool:
        return self.sa.dtype == np.int64

    @classmethod
    def from_arrays(cls, *, k: int, names, codes, sa, txp_of_pos,
                    txp_offsets, txp_lens, kmer_ht: dict | None,
                    prefix_bases: int = 0) -> "QuasiIndex":
        """An index from its defining arrays and scalars (plain numpy,
        for example another implementation's index).  The arrays derived
        from the text and the suffix array — packed words, separator
        distances and the prefix table — are recomputed here."""
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        sa = np.ascontiguousarray(sa)
        if sa.dtype not in (np.int32, np.int64):
            raise TypeError(f"suffix array must be int32 or int64 "
                            f"(got {sa.dtype})")
        if sa.shape != codes.shape:
            raise ValueError("suffix array and text differ in length")
        if not prefix_bases:
            prefix_bases = _auto_prefix_bases(len(codes), k)
        prefix_bases = min(prefix_bases, k, 16)
        packed16 = dna.pack_words_u32(codes, sub=0)
        if kmer_ht is not None:
            kmer_ht = {
                **{kk: np.asarray(kmer_ht[kk])
                   for kk in ("ht_key0", "ht_key1", "ht_lo", "ht_cnt")},
                "ht_bits": int(kmer_ht["ht_bits"]),
                "max_probes": int(kmer_ht["max_probes"]),
            }
        return cls(
            k=int(k), prefix_bases=prefix_bases, names=list(names),
            codes=codes, sa=sa, packed16=packed16,
            sep_dist=sep_distances(codes),
            table_lo=_prefix_table(packed16, sa, prefix_bases),
            kmer_ht=kmer_ht,
            txp_of_pos=np.asarray(txp_of_pos, dtype=np.int32),
            txp_offsets=np.asarray(txp_offsets, dtype=np.int64),
            txp_lens=np.asarray(txp_lens, dtype=np.int32),
        )

    # ---- host-side search helpers (used by refimpl + tests) ----

    def prefix_interval(self, pattern_codes: np.ndarray) -> tuple[int, int]:
        """SA interval of suffixes starting with the first P bases of
        pattern (under A-substituted ordering)."""
        v = dna.kmer_index(np.where(pattern_codes >= 4, 0, pattern_codes),
                           self.prefix_bases)
        return int(self.table_lo[v]), int(self.table_lo[v + 1])


def build_suffix_array(codes_sub: np.ndarray) -> np.ndarray:
    """Suffix array of a small-alphabet uint8 text.

    Uses the native SA-IS implementation when built; otherwise a
    numpy prefix-doubling construction (O(n log^2 n), fully vectorized).
    """
    sa = native_build_sa(codes_sub)
    if sa is not None:
        n = len(codes_sub)
        return sa.astype(np.int64) if n >= 2**31 else sa

    n = len(codes_sub)
    if n == 0:
        return np.empty(0, dtype=np.int32)
    dtype = np.int64 if n >= 2**31 else np.int32
    rank = codes_sub.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    h = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        # key = (rank[i], rank[i+h]) with out-of-range -> -1
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - h] = rank[h:]
        order = np.lexsort((key2, rank))
        sa = order
        # re-rank
        r_sa = rank[sa]
        k2_sa = key2[sa]
        new_group = np.empty(n, dtype=bool)
        new_group[0] = True
        new_group[1:] = (r_sa[1:] != r_sa[:-1]) | (k2_sa[1:] != k2_sa[:-1])
        tmp[sa] = np.cumsum(new_group) - 1
        rank, tmp = tmp, rank
        if rank[sa[-1]] == n - 1:
            break
        h *= 2
    return sa.astype(dtype)


def _prefix_table(packed16: np.ndarray, sa: np.ndarray,
                  prefix_bases: int) -> np.ndarray:
    """SA interval start per P-base prefix: pref(sa) is non-decreasing."""
    shift = np.uint32(2 * (16 - prefix_bases))
    pref = (packed16[sa] >> shift).astype(np.int64)
    counts = np.bincount(pref, minlength=4**prefix_bases)
    table_lo = np.zeros(4**prefix_bases + 1, dtype=sa.dtype)
    np.cumsum(counts, out=table_lo[1:])
    return table_lo


def _auto_prefix_bases(n: int, k: int) -> int:
    """Pick P so the expected interval per prefix is ~8-16 suffixes,
    bounded by the packed-word width and k."""
    p = 4
    while 4 ** (p + 1) < n // 8 and p < 12:
        p += 1
    return max(4, min(p, k, 16))


def build_index(
    names: list[str],
    seqs: list[np.ndarray],
    k: int = 31,
    prefix_bases: int = 0,
    force_big_sa: bool = False,
    ht_min_bits: int = 0,
) -> QuasiIndex:
    """`force_big_sa` builds the 64-bit (int64 SA) index layout
    regardless of text size — the scaled-down test mode for big-SA
    indexes (the auto threshold mirrors the reference's selection at
    2^31 bases, include/SailfishIndex.hpp:123-140)."""
    if k % 2 == 0 or k < 5 or k > 31:
        # reference requires odd k (SailfishIndexer.cpp:199-205); we also
        # bound k < 32 so a k-mer fits two packed words.
        raise ValueError(f"k must be odd and in [5, 31]; got {k}")
    T = len(names)
    txp_lens = np.array([len(s) for s in seqs], dtype=np.int32)
    n_total = int(txp_lens.sum()) + T  # + SEP after each transcript
    codes = np.empty(n_total, dtype=np.uint8)
    txp_offsets = np.empty(T, dtype=np.int64)
    pos = 0
    for i, s in enumerate(seqs):
        txp_offsets[i] = pos
        codes[pos : pos + len(s)] = s
        codes[pos + len(s)] = dna.SEP
        pos += len(s) + 1

    if not prefix_bases:
        prefix_bases = _auto_prefix_bases(n_total, k)
    prefix_bases = min(prefix_bases, k, 16)

    codes_sub = np.where(codes >= 4, 0, codes).astype(np.uint8)
    sa = build_suffix_array(codes_sub)
    if force_big_sa:
        sa = sa.astype(np.int64)
    packed16 = dna.pack_words_u32(codes, sub=0)
    sep_dist = sep_distances(codes)
    kmer_ht = (build_kmer_table(packed16, sa, k, min_bits=ht_min_bits)
               if k >= 17 else None)

    table_lo = _prefix_table(packed16, sa, prefix_bases)

    txp_of_pos = np.repeat(
        np.arange(T, dtype=np.int32), (txp_lens + 1).astype(np.int64)
    )

    return QuasiIndex(
        k=k,
        prefix_bases=prefix_bases,
        names=list(names),
        codes=codes,
        sa=sa,
        packed16=packed16,
        sep_dist=sep_dist,
        table_lo=table_lo,
        kmer_ht=kmer_ht,
        txp_of_pos=txp_of_pos,
        txp_offsets=txp_offsets,
        txp_lens=txp_lens,
    )


def build_index_from_fasta(path: str, k: int = 31, prefix_bases: int = 0) -> QuasiIndex:
    names, seqs = read_fasta(path)
    return build_index(names, seqs, k=k, prefix_bases=prefix_bases)


# ---------------- serialization ----------------
# Mirrors the reference's header.json / versionInfo.json semantics
# (include/SailfishIndex.hpp:104-144, include/SailfishIndexVersionInfo.hpp).

def save_index(idx: QuasiIndex, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    header = {
        "index_version": INDEX_VERSION,
        "kmer_length": idx.k,
        "prefix_bases": idx.prefix_bases,
        "num_transcripts": idx.num_transcripts,
        "text_len": idx.text_len,
        "big_sa": bool(idx.big_sa),
        "has_kmer_ht": idx.kmer_ht is not None,
        "ht_bits": idx.kmer_ht["ht_bits"] if idx.kmer_ht else 0,
        "ht_max_probes": idx.kmer_ht["max_probes"] if idx.kmer_ht else 0,
    }
    with open(os.path.join(out_dir, "header.json"), "w") as fh:
        json.dump(header, fh, indent=2)
    # versionInfo.json kept for parity with the reference's index layout
    with open(os.path.join(out_dir, "versionInfo.json"), "w") as fh:
        json.dump({"indexVersion": INDEX_VERSION, "kmerLength": idx.k}, fh, indent=2)
    with open(os.path.join(out_dir, "txp_names.txt"), "w") as fh:
        fh.write("\n".join(idx.names) + "\n")
    arrays = dict(
        codes=idx.codes,
        sa=idx.sa,
        packed16=idx.packed16,
        sep_dist=idx.sep_dist,
        table_lo=idx.table_lo,
        txp_of_pos=idx.txp_of_pos,
        txp_offsets=idx.txp_offsets,
        txp_lens=idx.txp_lens,
    )
    if idx.kmer_ht is not None:
        for kk in ("ht_key0", "ht_key1", "ht_lo", "ht_cnt"):
            arrays[kk] = idx.kmer_ht[kk]
    # raw .npy per array: plain npy reads at disk speed and supports
    # mmap, where extraction from a zip container throttles the load of
    # a multi-GB index
    adir = os.path.join(out_dir, "arrays")
    os.makedirs(adir, exist_ok=True)
    for kk, arr in arrays.items():
        np.save(os.path.join(adir, kk + ".npy"), arr)
    legacy = os.path.join(out_dir, "arrays.npz")
    if os.path.exists(legacy):
        os.remove(legacy)


def load_index(index_dir: str) -> QuasiIndex:
    with open(os.path.join(index_dir, "header.json")) as fh:
        header = json.load(fh)
    if header.get("sharded"):
        raise NotImplementedError(
            "sharded indexes (--indexShards) are not supported by the "
            "torch port yet")
    if header["index_version"] != INDEX_VERSION:
        raise ValueError(
            f"index version {header['index_version']} != {INDEX_VERSION}; "
            "please rebuild the index"
        )
    with open(os.path.join(index_dir, "txp_names.txt")) as fh:
        names = fh.read().splitlines()
    adir = os.path.join(index_dir, "arrays")
    if os.path.isdir(adir):
        arrays = {
            f[:-4]: np.load(os.path.join(adir, f))
            for f in os.listdir(adir) if f.endswith(".npy")
        }
    else:  # the older single-file layout
        arrays = np.load(os.path.join(index_dir, "arrays.npz"))
    kmer_ht = None
    if header.get("has_kmer_ht"):
        kmer_ht = {
            "ht_key0": arrays["ht_key0"],
            "ht_key1": arrays["ht_key1"],
            "ht_lo": arrays["ht_lo"],
            "ht_cnt": arrays["ht_cnt"],
            "ht_bits": header["ht_bits"],
            "max_probes": header["ht_max_probes"],
        }
    return QuasiIndex(
        k=header["kmer_length"],
        prefix_bases=header["prefix_bases"],
        names=names,
        codes=arrays["codes"],
        sa=arrays["sa"],
        packed16=arrays["packed16"],
        sep_dist=arrays["sep_dist"],
        table_lo=arrays["table_lo"],
        kmer_ht=kmer_ht,
        txp_of_pos=arrays["txp_of_pos"],
        txp_offsets=arrays["txp_offsets"],
        txp_lens=arrays["txp_lens"],
    )
