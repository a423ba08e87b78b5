"""The scan kernel's least time on given inputs, from the work they need.

`scan_bound` and `bound_ms` are frozen copies of `chip_smoke.py`'s
(commit f7d73a689aa0), with `seed_bytes` folded in for the k-mer route.
`scan_work` counts the work the way the port's plain scan counts it
(`map/scan.py::mmp_scan_reference(work=...)`, k-mer route): per lane
the probed positions, the seeds found with at most C occurrences, their
candidates, the text bytes each compare needs (the common prefix and the
mismatching byte), and the candidates of lanes whose MMP reached k,
which are written to slots.  It runs on the benchmark's own k-mer table,
so the bound reads the same work whatever implements the scan.  One
departure: a probe is counted as one 64-byte table row, the least any
hash lookup reads, where the plain scan counts the rows its table's
probe sequence visits; the bound is lower by that, never higher.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 operations/s
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def bound_ms(nbytes: float, nops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    operation rate, in ms."""
    return max(1e3 * nbytes / PEAK_BYTES_S, 1e3 * nops / PEAK_OPS_S)


def scan_bound(n: int, L: int, work: dict, C: int, M: int,
               pos_bytes: int = 4) -> float:
    """Least ms of one scan call over n lanes of width L: per lane L code
    bytes, 4 L packed-word bytes, its length and 16 bytes of meta; 64
    bytes a table row; a suffix-array entry and the compared text bytes
    a candidate; a `txp_of_pos` and a `txp_offsets` entry a stored
    candidate; M C slots of 9 bytes a lane.  Operations: about 40 a
    probe, 10 a candidate, 6 a compared byte."""
    nbytes = (n * (5 * L + 4 + 16) + 64 * work["buckets"]
              + pos_bytes * work["candidates"] + work["text_bytes"]
              + (4 + pos_bytes) * work["stored"] + n * M * C * 9)
    nops = (40 * work["steps"] + 10 * work["candidates"]
            + 6 * work["text_bytes"])
    return bound_ms(nbytes, nops)


def scan_work(table, reads: np.ndarray, C: int, M: int,
              jump: bool = False) -> dict:
    """Work of the scan over the lanes of `reads` ((n, len) codes 0-3,
    one length) in both orientations, on `table`
    (reference/mapper.py KmerTable)."""
    k = table.k
    lanes = np.concatenate([reads, (3 - reads)[:, ::-1]]).astype(np.uint8)
    nl, L = lanes.shape
    nk = L - k + 1
    keys = np.zeros((nl, nk), np.uint64)
    for j in range(k):
        keys <<= np.uint64(2)
        keys |= lanes[:, j:j + nk].astype(np.uint64)
    lo_all, hi_all = (a.reshape(nl, nk)
                      for a in table.occurrences(keys.reshape(-1)))
    del keys
    text, n_text = table.text, len(table.text)
    i = np.zeros(nl, np.int64)
    nm = np.zeros(nl, np.int64)
    w = dict(steps=0, seeds=0, candidates=0, text_bytes=0, stored=0)
    jj = np.arange(L)
    for _ in range(L):
        act = np.nonzero((i + k <= L) & (nm < M))[0]
        if len(act) == 0:
            break
        ia = i[act]
        lo, hi = lo_all[act, ia], hi_all[act, ia]
        cnt = hi - lo
        w["steps"] += len(act)
        sel = np.nonzero((cnt > 0) & (cnt <= C))[0]
        w["seeds"] += len(sel)
        adv = np.ones(len(act), np.int64)
        if len(sel):
            cs = cnt[sel]
            own = np.repeat(np.arange(len(sel)), cs)
            c = np.arange(len(own)) - np.repeat(np.cumsum(cs) - cs, cs)
            g = np.asarray(table.pos[lo[sel][own] + c], np.int64)
            lane, i0 = act[sel][own], ia[sel][own]
            lcp = np.zeros(len(own), np.int64)
            for s in range(0, len(own), 1 << 16):
                ln, ii, gg = lane[s:s + (1 << 16)], i0[s:s + (1 << 16)], \
                    g[s:s + (1 << 16)]
                rc = lanes[ln[:, None], np.minimum(ii[:, None] + jj, L - 1)]
                tc = text[np.minimum(gg[:, None] + jj, n_text - 1)]
                ok = (jj < (L - ii)[:, None]) & (rc == tc)
                lcp[s:s + len(ln)] = np.where(ok.all(1), L, np.argmin(ok, 1))
            rem = L - i0
            w["candidates"] += len(own)
            w["text_bytes"] += int(lcp.sum() + (lcp < rem).sum())
            lstar = np.full(len(sel), -1, np.int64)
            np.maximum.at(lstar, own, lcp)
            hit = lstar >= k
            w["stored"] += int(hit[own].sum())
            nm[act[sel][hit]] += 1
            hadv = lstar + 1 if jump else np.maximum(lstar - k + 1, 1)
            adv[sel] = np.where(hit, hadv, 1)
        i[act] = ia + adv
    w["buckets"] = w["steps"]
    return w
