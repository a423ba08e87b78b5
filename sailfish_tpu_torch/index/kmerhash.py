"""Open-addressing k-mer -> SA-interval hash table, built host-side and
probed on device with a short linear scan.

Counterpart of sailfish_tpu/index/kmerhash.py, without that module's
presence (Bloom) filters: they serve the TPU path's lane screen, which
the port does not have.  The table is the analog of RapMap's sparsehash
k-mer table (reference CMakeLists.txt:466-474): keys
are the first k bases of each suffix (A-substituted, packed 2-bit into
two uint32 words), values the SA interval [lo, lo+cnt) of suffixes
sharing them.  A device lookup replaces the O(log n) packed-word binary
search with an expected O(1) probe chain; the exact maximum probe length
is computed at build time and stored so the device loop bound is static
AND exact.

Layout (table size S = power of two, load factor <= 0.5):
  ht_key0, ht_key1  uint32[S]
  ht_lo             int32[S]
  ht_cnt            int32[S]   (0 = empty slot)
"""

from __future__ import annotations

import numpy as np

_M0 = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xC2B2AE3D27D4EB4F)


def mix_hash(key0: np.ndarray, key1: np.ndarray) -> np.ndarray:
    """64-bit multiply-xor mix of two uint32 words -> uint64 hash."""
    h = key0.astype(np.uint64) * _M0 ^ key1.astype(np.uint64) * _M1
    h ^= h >> np.uint64(29)
    h *= _M0
    h ^= h >> np.uint64(32)
    return h


def mix_hash_u32(key0, key1):
    """Device-friendly 32-bit variant (same structure, uint32 ops).
    Must match bits.py `mix_kmer` and csrc/mmp_scan.cu `mix_kmer`."""
    k0 = np.asarray(key0, np.uint32)
    k1 = np.asarray(key1, np.uint32)
    h = (k0 * np.uint32(0x9E3779B1)) ^ (k1 * np.uint32(0x85EBCA77))
    h ^= h >> np.uint32(15)
    h *= np.uint32(0xC2B2AE3D)
    h ^= h >> np.uint32(13)
    return h


def suffix_keys(packed16: np.ndarray, sa: np.ndarray, k: int):
    """(key0, key1) of the first k bases of each SA suffix (A-sub)."""
    assert 17 <= k <= 32
    n = len(packed16)
    pad = np.zeros(32, dtype=np.uint32)
    p = np.concatenate([packed16, pad])
    key0 = p[sa]
    key1 = p[sa + 16] >> np.uint32(2 * (32 - k))
    return key0, key1


BUCKET = 4  # entries per bucket; one bucket = 4x4 u32 = 64 contiguous bytes


def build_kmer_table(packed16: np.ndarray, sa: np.ndarray, k: int,
                     min_bits: int = 0):
    """Group identical k-prefixes along the SA and insert them into a
    4-way bucketized open-addressing table (linear probing over
    BUCKETS).  Bucketization keeps the worst-case probe chain tiny
    (max_probes is typically <= 3 at load factor 0.5) and each probe
    reads 4 contiguous entries.

    Returns dict(ht_key0, ht_key1, ht_lo, ht_cnt — each (S, BUCKET) —
    ht_bits = log2(S), max_probes).
    """
    n = len(sa)
    key0, key1 = suffix_keys(packed16, sa, k)
    new = np.ones(n, dtype=bool)
    new[1:] = (key0[1:] != key0[:-1]) | (key1[1:] != key1[:-1])
    lo = np.nonzero(new)[0].astype(np.int64)
    cnt = np.empty(len(lo), np.int64)
    if len(lo):
        np.subtract(lo[1:], lo[:-1], out=cnt[:-1])
        cnt[-1] = n - lo[-1]
    g0 = key0[lo]
    g1 = key1[lo]
    G = len(lo)

    # min_bits: a floor on the table size (index shards must agree on it)
    bits = max(2, min_bits)
    while (1 << bits) * BUCKET < 2 * G:
        bits += 1
    S = 1 << bits
    mask = np.uint32(S - 1)

    h = (mix_hash_u32(g0, g1) & mask).astype(np.int64)
    slot_of_group = np.full(G, -1, dtype=np.int64)   # flat slot = b*BUCKET+j
    # linear-probe insertion as ONE vectorized cascade: in home order
    # (stable), each group takes the first free slot >= BUCKET*home —
    # a running-max recurrence t_g = max(t_{g-1}+1, BUCKET*h_g) =
    # g + cummax(BUCKET*h_g - g).  Any probe path from a group's home
    # to its landing bucket crosses only full buckets (slots between a
    # group's home start and its landing slot are all taken by
    # construction; gaps only open at strictly later stream positions
    # with strictly later homes), so lookups that stop at an empty
    # slot or at max_probes stay exact.  This replaces an iterative
    # rounds loop that re-sorted the pending set ~7 times.
    # stable order-by-home via ONE value sort of a composite key
    # (home << id_bits | id): quicksort over int64 values beats a
    # stable argsort ~2x at GENCODE-scale G
    id_bits = max(int(np.int64(max(G, 2) - 1)).bit_length(), 1)
    comb = np.sort(
        (h << np.int64(id_bits)) | np.arange(G, dtype=np.int64)
    )
    order = comb & np.int64((1 << id_bits) - 1)
    hs = comb >> np.int64(id_bits)
    g_idx = np.arange(G, dtype=np.int64)
    t = g_idx + np.maximum.accumulate(BUCKET * hs - g_idx)
    inb = t < BUCKET * S
    slot_of_group[order[inb]] = t[inb]
    leftover = order[~inb]
    if len(leftover):
        # the cascade ran past the table end: those few groups wrap to
        # bucket 0 and continue with the iterative insertion
        fill = np.bincount(t[inb] // BUCKET, minlength=S).astype(np.int64)
        todo = leftover
        idx = np.zeros(G, dtype=np.int64)
        rounds = 0
        while len(todo):
            rounds += 1
            if rounds > 4096:
                raise RuntimeError("k-mer hash insertion did not converge")
            tgt = idx[todo]
            osort = np.argsort(tgt, kind="stable")
            cand = todo[osort]
            tgt = tgt[osort]
            pos = np.arange(len(cand))
            first = np.ones(len(cand), dtype=bool)
            first[1:] = tgt[1:] != tgt[:-1]
            grp = np.cumsum(first) - 1
            rank = pos - pos[first][grp]
            slot_j = fill[tgt] + rank
            ok = slot_j < BUCKET
            placed = cand[ok]
            slot_of_group[placed] = tgt[ok] * BUCKET + slot_j[ok]
            np.add.at(fill, tgt[ok], 1)
            remaining = cand[~ok]
            idx[remaining] = (idx[remaining] + 1) & int(mask)
            todo = remaining
    # exact probe distance per key (modular covers the wrapped ones)
    max_probes = int(
        (((slot_of_group // BUCKET) - h) % S).max() + 1
    ) if G else 1

    ht_key0 = np.zeros(S * BUCKET, dtype=np.uint32)
    ht_key1 = np.zeros(S * BUCKET, dtype=np.uint32)
    # SA-index dtype follows the suffix array (int64 for big_sa indexes)
    ht_lo = np.zeros(S * BUCKET, dtype=sa.dtype)
    ht_cnt = np.zeros(S * BUCKET, dtype=np.int32)
    ht_key0[slot_of_group] = g0
    ht_key1[slot_of_group] = g1
    ht_lo[slot_of_group] = lo.astype(sa.dtype)
    ht_cnt[slot_of_group] = cnt.astype(np.int64).astype(np.int32)
    shape = (S, BUCKET)
    return {
        "ht_key0": ht_key0.reshape(shape),
        "ht_key1": ht_key1.reshape(shape),
        "ht_lo": ht_lo.reshape(shape),
        "ht_cnt": ht_cnt.reshape(shape),
        "ht_bits": bits,
        "max_probes": int(max_probes),
    }


def sep_distances(codes: np.ndarray, cap: int = 255) -> np.ndarray:
    """uint8[N]: distance from each position to the next SEP (>=4),
    saturating at `cap`.  Used to terminate A-substituted LCPs at
    transcript boundaries: true_lcp = min(asub_lcp, sep_dist)."""
    n = len(codes)
    next_sep = np.full(n, n, dtype=np.int64)
    sep_pos = np.nonzero(codes >= 4)[0]
    if len(sep_pos):
        # next sep at or after each position
        idx = np.searchsorted(sep_pos, np.arange(n), side="left")
        has = idx < len(sep_pos)
        next_sep[has] = sep_pos[idx[has]]
    d = np.minimum(next_sep - np.arange(n), cap)
    return d.astype(np.uint8)
