"""The eq classes of a fragment sample, from the world's exon structure
(the inference cells' input; no mapping).

A fragment of transcript t covering [p, p + fl) spans a run of t's
segments (kept exons, or the random tail appended to a short isoform).
Its class is the isoforms of t's gene that hold the same run: those that
keep the same exons as t between the run's first and last exon of the
gene, and, when the run touches t's own tail, t alone.  Fragments of
different genes never share sequence in these worlds (the exons are
random), so the class lies inside the gene.  A gene has at most 32
isoforms and 62 exons (the bit masks are int64).
"""

from __future__ import annotations

import numpy as np


def fragment_classes(world: dict, t: np.ndarray, p: np.ndarray,
                     fl: np.ndarray):
    """The classes of fragments (t, p, fl) as (labels, counts): labels a
    list of tuples of transcript ids (ascending), counts int64."""
    gene_of, mask_of = world["gene_of"], world["mask_of"]
    seg_txp, seg_exon = world["seg_txp"], world["seg_exon"]
    seg_start = np.zeros(len(seg_txp) + 1, np.int64)
    np.cumsum(world["seg_len"], out=seg_start[1:])
    # segments are in transcript order and cover the concatenated codes
    g0 = world["offs"][t] + p
    a = np.searchsorted(seg_start, g0, "right") - 1
    b = np.searchsorted(seg_start, g0 + fl - 1, "right") - 1
    tail = (seg_exon[a] < 0) | (seg_exon[b] < 0)
    ea = np.where(tail, 0, seg_exon[a]).astype(np.int64)
    eb = np.where(tail, 0, seg_exon[b]).astype(np.int64)
    # the class follows from (t, first exon, last exon, tail): solve it
    # once for each distinct one
    u, inv = np.unique(t.astype(np.int64) << 13 | ea << 7 | eb << 1 | tail,
                       return_inverse=True)
    t, ea, eb, tail = u >> 13, u >> 7 & 63, u >> 1 & 63, (u & 1).astype(bool)
    run = np.where(tail, 0, (1 << (eb + 1)) - (1 << ea))
    # the gene's isoforms are consecutive transcript ids
    first = np.searchsorted(gene_of, gene_of, "left")
    n_iso = np.searchsorted(gene_of, gene_of, "right") - first
    bits = np.zeros(len(t), np.int64)
    for j in range(int(n_iso.max())):
        tj = first[t] + j
        ok = (j < n_iso[t]) & ~tail
        tj = np.where(ok, tj, 0)
        ok &= (mask_of[tj] & run) == (mask_of[t] & run)
        bits |= ok.astype(np.int64) << j
    bits = np.where(tail, np.int64(1) << (t - first[t]), bits)
    keys = (first[t].astype(np.int64) << 32 | bits)[inv.reshape(-1)]
    uk, counts = np.unique(keys, return_counts=True)
    labels = []
    for key in uk.tolist():
        f, m = key >> 32, key & 0xFFFFFFFF
        labels.append(tuple(f + j for j in range(32) if m >> j & 1))
    return labels, counts.astype(np.int64)


def effective_lengths(lens: np.ndarray, fl: np.ndarray) -> np.ndarray:
    """Effective length of each transcript under the sample's own
    fragment-length distribution: the mean number of start positions,
    sum over l <= L of P(l) (L - l + 1) / sum over l <= L of P(l); the
    length itself where no fragment length fits, and at least 1."""
    hist = np.bincount(fl, minlength=int(lens.max()) + 1).astype(np.float64)
    hist = hist[:int(lens.max()) + 1]
    ls = np.arange(len(hist), dtype=np.float64)
    cum_p = np.cumsum(hist)
    cum_lp = np.cumsum(hist * ls)
    L = lens.astype(np.int64)
    mass = cum_p[L]
    mean_start = np.where(
        mass > 0, (L + 1) - cum_lp[L] / np.where(mass > 0, mass, 1.0),
        L.astype(np.float64))
    return np.maximum(mean_start, 1.0)
