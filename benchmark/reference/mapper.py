"""Plain reference of the mapping: a fragment's eq-class label from the
transcripts and the reads, in NumPy.

The semantics are a frozen copy of the port's numpy reference mapper
(`sailfish_tpu_torch/refimpl/mapper.py` at commit f7d73a689aa0, paired
end only) and of the library-format rules it calls
(`sailfish_tpu_torch/libformat.py`).  The index is the benchmark's own:
a table of every k-mer of the text (transcripts, each followed by a
separator), keyed with separators read as A, sorted (`KmerTable`).  The
candidates of a probe are that k-mer's occurrences, which is the exact-k
suffix-array interval the port's reference restricts its prefix interval
to.  Nothing here imports the port.

Per oriented read: scan positions from 0; at i the candidates are the
occurrences of read[i:i+k]; more than the capacity marks the read
overflowed and moves on by one; else the longest true common prefix l*
over the candidates, and l* >= k makes an MMP of the candidates reaching
it, after which i moves by max(1, l* - k + 1) ("nip") or l* + 1
("jump").  A transcript locus is a hit when the first MMP implies it and
every later MMP supports it.  Mates pair on shared transcripts, else
become orphans; library compatibility picks the label.  A probe whose k
bases hold an N is passed over (the port's reference looks at its first
P bases only); the benchmark's reads hold no N.
"""

from __future__ import annotations

import os

import numpy as np

SEP = 4
# paired-end named formats: (orientation, strandedness)
# orientation SAME 0, AWAY 1, TOWARD 2; strandedness SA 0, AS 1, S 2, A 3, U 4
PAIRED_FORMATS = {
    "IU": (2, 4), "ISF": (2, 0), "ISR": (2, 1),
    "OU": (1, 4), "OSF": (1, 0), "OSR": (1, 1),
    "MU": (0, 4), "MSF": (0, 2), "MSR": (0, 3),
}
SAME, AWAY, TOWARD = 0, 1, 2
SA_, AS_, S_, A_, U_ = 0, 1, 2, 3, 4
LEFT, RIGHT, PAIRED = 1, 2, 3


# ---------------------------------------------------------------- index
def text_of(concat: np.ndarray, offs: np.ndarray):
    """The indexed text (each transcript followed by a separator) and
    each transcript's start in it."""
    T = len(offs) - 1
    lens = np.diff(offs)
    starts = offs[:-1] + np.arange(T)
    text = np.full(int(offs[-1]) + T, SEP, np.uint8)
    idx = np.repeat(starts - offs[:-1], lens) + np.arange(int(offs[-1]))
    text[idx] = concat
    return text, starts


def kmer_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Key of every k-mer of `codes` (separators and Ns read as A), the
    earliest base most significant."""
    c = np.where(codes >= 4, 0, codes).astype(np.uint64)
    n = len(c) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    key = np.zeros(n, np.uint64)
    for j in range(k):
        key <<= np.uint64(2)
        key |= c[j:j + n]
    return key


class KmerTable:
    """Every k-mer occurrence of the text, sorted by key."""

    def __init__(self, text, starts, keys, pos, k: int):
        self.text, self.starts, self.keys, self.pos, self.k = (
            text, starts, keys, pos, k)

    @classmethod
    def build(cls, concat, offs, k: int) -> "KmerTable":
        text, starts = text_of(concat, offs)
        keys = kmer_keys(text, k)
        order = np.argsort(keys, kind="stable")
        pos = order.astype(np.int64 if len(text) >= 2**31 else np.int32)
        return cls(text, starts, keys[order], pos, k)

    def save(self, d: str) -> None:
        os.makedirs(d, exist_ok=True)
        for name in ("text", "starts", "keys", "pos"):
            np.save(os.path.join(d, name + ".npy"), getattr(self, name))
        with open(os.path.join(d, "k.txt"), "w") as f:
            f.write(str(self.k))

    @classmethod
    def load(cls, d: str) -> "KmerTable":
        def ld(name):
            return np.load(os.path.join(d, name + ".npy"), mmap_mode="r")

        with open(os.path.join(d, "k.txt")) as f:
            k = int(f.read())
        return cls(ld("text"), np.asarray(ld("starts")), ld("keys"),
                   ld("pos"), k)

    def occurrences(self, keys: np.ndarray):
        """(lo, hi) of each key's run in the sorted table (looked up in
        key order, which keeps the table's pages warm)."""
        u, inv = np.unique(keys, return_inverse=True)
        return (np.searchsorted(self.keys, u, "left")[inv],
                np.searchsorted(self.keys, u, "right")[inv])


def load_or_build_table(concat, offs, k: int, d: str) -> KmerTable:
    if os.path.exists(os.path.join(d, "k.txt")):
        return KmerTable.load(d)
    KmerTable.build(concat, offs, k).save(d)
    return KmerTable.load(d)


# ---------------------------------------------------------------- mapper
def revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes)[::-1].astype(np.uint8)


class Mapper:
    """The reference mapper over a `KmerTable`, with the options of the
    configuration's `quant` block."""

    def __init__(self, table: KmerTable, quant: dict):
        self.t = table
        self.k = table.k
        # the port's envelope: the escalation capacity when it is on
        self.cap = max(quant["hit_capacity"], quant["hit_capacity_max"])
        self.max_mmps = quant["max_mmps"]
        self.jump = quant["mmp_skip"] == "jump"
        self.q = quant
        self.orient, self.strand = PAIRED_FORMATS[quant["lib_type"]]
        self.n = len(table.text)

    def _txp_pos(self, g: np.ndarray):
        t = np.searchsorted(self.t.starts, g, "right") - 1
        return t, g - self.t.starts[t]

    def _mmps(self, read: np.ndarray):
        """MMPs of one oriented read: [(qpos, l*, global positions)], and
        whether a probe overflowed the capacity."""
        k, L = self.k, len(read)
        mmps, overflow = [], False
        if L < k:
            return mmps, overflow
        lo, hi = self.t.occurrences(kmer_keys(read, k))
        i = steps = 0
        while i + k <= L and steps < L and len(mmps) < self.max_mmps:
            steps += 1
            if np.any(read[i:i + k] >= 4):
                i += 1
                continue
            cnt = hi[i] - lo[i]
            if cnt > self.cap:
                overflow = True
                i += 1
                continue
            if cnt == 0:
                i += 1
                continue
            g = np.asarray(self.t.pos[lo[i]:hi[i]], np.int64)
            m = np.minimum(L - i, self.n - g)
            w = int(m.max())
            span = np.minimum(g[:, None] + np.arange(w), self.n - 1)
            miss = self.t.text[span] != read[i:i + w][None, :]
            miss &= np.arange(w)[None, :] < m[:, None]
            lcps = np.where(miss.any(1), np.argmax(miss, 1), m)
            lstar = int(lcps.max())
            if lstar < k:
                i += 1
                continue
            mmps.append((i, lstar, g[lcps == lstar]))
            i += lstar + 1 if self.jump else max(1, lstar - k + 1)
        return mmps, overflow

    def _orient_hits(self, read, fwd: bool):
        """{txp: (pos, fwd, mlen)}: loci of the first MMP supported by
        every later one, the smallest position per transcript."""
        mmps, overflow = self._mmps(read)
        if not mmps:
            return {}, overflow
        q0, l0, base = mmps[0]
        t, p = self._txp_pos(base)
        loci = {(int(a), int(b) - q0) for a, b in zip(t, p)}
        for qi, _, cands in mmps[1:]:
            t, p = self._txp_pos(cands)
            loci &= {(int(a), int(b) - qi) for a, b in zip(t, p)}
            if not loci:
                return {}, overflow
        hits = {}
        for tx, pos in sorted(loci):
            if tx not in hits:
                hits[tx] = (pos, fwd, l0)
        return hits, overflow

    def _read_hits(self, read):
        fw, of1 = self._orient_hits(read, True)
        rc, of2 = self._orient_hits(revcomp(read), False)
        hits = dict(fw)
        for tx, h in rc.items():
            if tx not in hits or h[2] > hits[tx][2]:
                hits[tx] = h
        return hits, of1 or of2

    # -- library format (libformat.py hit_type / compatible_hit_*)
    def _hit_type(self, s1, f1, len1, s2, f2, len2):
        dove = self.q["allow_dovetail"]
        if f1 != f2:
            if f1:
                stretch = len2 if dove else 0
                o = TOWARD if s1 <= s2 + stretch else AWAY
                return o, SA_
            stretch = len1 if dove else 0
            o = TOWARD if s2 <= s1 + stretch else AWAY
            return o, AS_
        return SAME, (S_ if f1 else A_)

    def _compat_paired(self, observed) -> bool:
        o, s = observed
        return o == self.orient and (self.strand == U_ or self.strand == s)

    def _compat_single(self, fwd: bool, status: int) -> bool:
        s = self.strand
        if status == LEFT or status == RIGHT:
            if self.orient == SAME:
                return s == U_ or (s == S_ and fwd) or (s == A_ and not fwd)
            if (status == LEFT) == fwd:
                return s in (U_, S_)
            return s in (U_, A_)
        return False

    def map_pair(self, r1: np.ndarray, r2: np.ndarray):
        """The fragment's eq-class label (a tuple of transcript ids) or
        None when it does not map."""
        q = self.q
        lh, of1 = self._read_hits(r1)
        rh, of2 = self._read_hits(r2)
        len1, len2 = len(r1), len(r2)
        shared = sorted(set(lh) & set(rh))
        joint = []     # (txp, status, fwd, pos, mate_fwd, mate_pos)
        if shared:
            for tx in shared:
                p1, f1, _ = lh[tx]
                p2, f2, _ = rh[tx]
                joint.append((tx, PAIRED, f1, p1, f2, p2))
        elif q["strict_intersect"] or not (lh and rh):
            orph = [(tx, LEFT, h[1], h[0], True, 0) for tx, h in lh.items()]
            orph += [(tx, RIGHT, h[1], h[0], True, 0)
                     for tx, h in rh.items()]
            orph.sort(key=lambda h: (h[0], h[1]))
            joint = orph if q["allow_orphans"] else []
        if len(joint) > q["max_read_occs"] or of1 or of2:
            return None
        compat_ids, all_ids = [], []
        have_compat = False
        for tx, status, fwd, pos, mfwd, mpos in joint:
            if status == PAIRED:
                e1 = pos if fwd else pos + len1
                e2 = mpos if mfwd else mpos + len2
                ok = q["ignore_lib_compat"] or self._compat_paired(
                    self._hit_type(e1, fwd, len1, e2, mfwd, len2))
            else:
                ok = q["ignore_lib_compat"] or self._compat_single(fwd,
                                                                   status)
            if ok:
                have_compat = True
                compat_ids.append(tx)
            if not have_compat and not q["enforce_lib_compat"]:
                all_ids.append(tx)
        if have_compat and compat_ids:
            return tuple(compat_ids)
        return tuple(all_ids) if all_ids else None


# ---------------------------------------------------------------- pool
_WORKER = None


def _init_worker(table_dir: str, quant: dict):
    global _WORKER
    _WORKER = Mapper(KmerTable.load(table_dir), quant)


def _map_chunk(args):
    m1, m2 = args
    return [_WORKER.map_pair(a, b) for a, b in zip(m1, m2)]


def map_pairs(table_dir: str, quant: dict, m1: np.ndarray, m2: np.ndarray,
              workers: int) -> list:
    """Labels of the fragments (m1[i], m2[i]) (unpadded mates), mapped in
    `workers` spawned processes that share the cached table."""
    if workers <= 1 or len(m1) < 64:
        _init_worker(table_dir, quant)
        return _map_chunk((m1, m2))
    import multiprocessing

    edges = np.linspace(0, len(m1), 4 * workers + 1).astype(int)
    parts = [(m1[a:b], m2[a:b]) for a, b in zip(edges[:-1], edges[1:])]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, _init_worker, (table_dir, quant)) as pool:
        out = pool.map(_map_chunk, parts, 1)
    return [lab for part in out for lab in part]
