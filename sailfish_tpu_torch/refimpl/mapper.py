"""Numpy reference quasi-mapper.

Implements the documented mapping semantics (modeled on RapMap's
SACollector / maximal-mappable-prefix search, which the reference
compiles in externally — see reference src/SailfishQuantify.cpp:141-213
for the call sites):

Per oriented read (the read as given = fwd, its reverse complement = rc):

1. Scan query positions left→right starting at 0.  At position i, find
   the suffix-array interval of suffixes sharing the first
   ``prefix_bases`` bases of read[i:]; compute the true longest-common-
   prefix (LCP) of read[i:] against every suffix in the interval
   (matches terminate at transcript separators automatically).
2. Let l* = max LCP.  If l* >= k the position yields an MMP: the set of
   suffixes achieving l*, each implying a (transcript, read-start
   position) locus; advance i by max(1, l* - k + 1).  Otherwise advance
   i by 1.
3. A transcript locus is a hit for the oriented read iff it is implied
   by the FIRST MMP and is consistent (same transcript, same implied
   read-start) with at least one locus of EVERY subsequent MMP.

Per read, fwd and rc hits are combined; if the same transcript is hit in
both orientations the orientation with the larger first-MMP match length
wins (ties prefer fwd).  Implied read-start positions may be negative
(read hanging off the transcript start), as in RapMap.

Paired-end merge (modeled on rapmap::utils::mergeLeftRightHitsFuzzy,
called at reference src/SailfishQuantify.cpp:204-213): transcripts hit
by both ends become PAIRED hits; if there are none (or one end is
unmapped), each end's hits become orphan hits (unless orphans are
discarded).  fragLen = max(end of either read) - min(start of either
read) in transcript coordinates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import dna
from ..config import QuantOpts
from ..index.builder import QuasiIndex
from ..libformat import (
    LibraryFormat,
    MateStatus,
    ReadOrientation,
    ReadStrandedness,
    ReadType,
    compatible_hit_paired,
    compatible_hit_single,
    hit_type,
)


@dataclasses.dataclass
class Hit:
    txp: int
    pos: int            # implied read start on the transcript (may be <0)
    fwd: bool
    mlen: int           # first-MMP match length (orientation tiebreak)
    mate_status: MateStatus = MateStatus.SINGLE_END
    # paired fields
    mate_pos: int = 0
    mate_fwd: bool = True
    frag_len: int = 0
    read_len: int = 0
    mate_len: int = 0


@dataclasses.dataclass
class ReadMapping:
    """Outcome for one fragment: the eq-class label (sorted tids, possibly
    with duplicates) or None, plus bookkeeping for counters."""
    label: tuple[int, ...] | None
    num_joint_hits: int
    frag_len: int            # valid iff unique_paired
    unique_paired: bool
    num_fwd: int
    num_rc: int
    fmt_id: int = -1         # observed libtype (formatID) of the first
    # selected hit; -1 when unmapped
    compat: bool = False     # label drawn from library-compatible hits
    joint: list = dataclasses.field(default_factory=list)  # ALL joint hits
    # post-clears, in order — the reference observes bias/GC over every
    # joint hit regardless of compat (src/SailfishQuantify.cpp:260-393)


class RefMapper:
    def __init__(self, index: QuasiIndex, opts: QuantOpts | None = None):
        self.idx = index
        self.opts = opts or QuantOpts()
        # per-probe candidate capacity, matching the device kernel's
        # effective envelope (the escalation capacity once the batch
        # escalation pass is enabled, else the primary hit capacity)
        self.cand_cap = self.opts.effective_hit_capacity()
        # suffix array positions sorted by A-substituted text
        self._sa = index.sa
        self._codes = index.codes
        self._n = len(index.codes)

    # ---------------- core MMP machinery ----------------

    def _lcp(self, read: np.ndarray, i: int, gpos: int) -> int:
        """LCP of read[i:] vs text[gpos:] under true codes."""
        m = min(len(read) - i, self._n - gpos)
        a = read[i : i + m]
        b = self._codes[gpos : gpos + m]
        neq = np.nonzero(a != b)[0]
        return int(neq[0]) if len(neq) else m

    def _asub_lcp(self, read: np.ndarray, i: int, gpos: int) -> int:
        """LCP of read[i:] vs text[gpos:] under A-substituted codes (the
        index's packed16 / k-mer hash convention: N and separators
        compare as A)."""
        m = min(len(read) - i, self._n - gpos)
        a = np.where(read[i : i + m] >= 4, 0, read[i : i + m])
        b = self._codes[gpos : gpos + m]
        b = np.where(b >= 4, 0, b)
        neq = np.nonzero(a != b)[0]
        return int(neq[0]) if len(neq) else m

    def _mmps(self, read: np.ndarray):
        """Collect MMPs for one oriented read.

        Returns (mmps, overflow): mmps a list of (qpos, l, [global suffix
        positions]); overflow True iff some probed position's exact
        k-mer SA interval exceeded the candidate capacity — the device
        kernel can only fetch `hit_capacity` candidates per probe, marks
        such lanes overflowed and the fragment is dropped like a
        > --maxReadOcc read.  Capacities (max_scan_steps / max_mmps /
        cand cap) mirror the device kernel's static bounds exactly.
        """
        idx, opts = self.idx, self.opts
        k, P = idx.k, idx.prefix_bases
        cap = self.cand_cap
        L = len(read)
        mmps = []
        overflow = False
        i = 0
        steps = 0
        budget = opts.effective_scan_steps(L)
        while i + k <= L and steps < budget and len(mmps) < opts.max_mmps:
            steps += 1
            window = read[i : i + P]
            if np.any(window >= 4):
                i += 1
                continue
            lo, hi = idx.prefix_interval(window)
            if hi <= lo:
                i += 1
                continue
            cand_gpos = np.asarray(self._sa[lo:hi], dtype=np.int64)
            # the device kernel's candidate set is the EXACT-k-mer SA
            # interval (A-substituted hash key); restrict to it so the
            # capacity check below matches the kernel bit-for-bit
            if cap is not None or P < k:
                a_lcps = np.array(
                    [self._asub_lcp(read, i, g) for g in cand_gpos]
                )
                in_k = a_lcps >= k
                cand_gpos = cand_gpos[in_k]
            if cap is not None and len(cand_gpos) > cap:
                overflow = True
                i += 1
                continue
            lcps = np.array([self._lcp(read, i, g) for g in cand_gpos])
            lstar = int(lcps.max()) if len(lcps) else 0
            if lstar < k:
                i += 1
                continue
            best = cand_gpos[lcps == lstar]
            mmps.append((i, lstar, best))
            if opts.mmp_skip == "jump":
                # next probe just past the mismatch that ended this MMP
                i += lstar + 1
            else:  # "nip": RapMap-style overlap re-probe
                i += max(1, lstar - k + 1)
        return mmps, overflow

    def _orient_hits(self, read: np.ndarray, fwd: bool):
        """Position-consistent intersection of MMP loci -> per-txp hit.
        Returns (hits, overflow)."""
        idx = self.idx
        mmps, overflow = self._mmps(read)
        if not mmps:
            return {}, overflow
        q0, l0, base = mmps[0]
        # implied loci of the first MMP
        loci = {}
        for g in base:
            t = int(idx.txp_of_pos[g])
            pos = int(g - idx.txp_offsets[t]) - q0
            loci[(t, pos)] = l0
        for qi, li, cands in mmps[1:]:
            support = set()
            for g in cands:
                t = int(idx.txp_of_pos[g])
                support.add((t, int(g - idx.txp_offsets[t]) - qi))
            loci = {tp: ml for tp, ml in loci.items() if tp in support}
            if not loci:
                return {}, overflow
        hits: dict[int, Hit] = {}
        for (t, pos), ml in sorted(loci.items()):
            if t not in hits:  # keep smallest pos per transcript
                hits[t] = Hit(txp=t, pos=pos, fwd=fwd, mlen=ml)
        return hits, overflow

    def map_single_oriented(self, read: np.ndarray):
        """Both orientations, one Hit per transcript.
        Returns (hits, overflow)."""
        fw, of1 = self._orient_hits(read, True)
        rc, of2 = self._orient_hits(dna.revcomp(read), False)
        hits = dict(fw)
        for t, h in rc.items():
            if t not in hits or h.mlen > hits[t].mlen:
                hits[t] = h
        return hits, of1 or of2

    # ---------------- fragment-level mapping ----------------

    def map_fragment_pe(
        self, read1: np.ndarray, read2: np.ndarray, expected: LibraryFormat
    ) -> ReadMapping:
        opts = self.opts
        lhits, of1 = self.map_single_oriented(read1)
        rhits, of2 = self.map_single_oriented(read2)
        overflow = of1 or of2
        len1, len2 = len(read1), len(read2)

        shared = sorted(set(lhits) & set(rhits))
        joint: list[Hit] = []
        if shared:
            for t in shared:
                h1, h2 = lhits[t], rhits[t]
                start = min(h1.pos, h2.pos)
                end = max(h1.pos + len1, h2.pos + len2)
                joint.append(
                    Hit(
                        txp=t,
                        pos=h1.pos,
                        fwd=h1.fwd,
                        mlen=h1.mlen,
                        mate_status=MateStatus.PAIRED_END_PAIRED,
                        mate_pos=h2.pos,
                        mate_fwd=h2.fwd,
                        frag_len=end - start,
                        read_len=len1,
                        mate_len=len2,
                    )
                )
        else:
            # orphans, in transcript order, left hits before right on ties
            # (reference sorts/merges jointHits by transcript id,
            # src/SailfishQuantify.cpp:231-246).  Gating mirrors the
            # reference's merge pair (:204-213): the default fuzzy merge
            # orphan-reports only when exactly ONE end mapped;
            # --strictIntersect reports BOTH ends' mappings as orphans
            # when the intersection is empty.
            orphans: list[Hit] = []
            both_ends = bool(lhits) and bool(rhits)
            if opts.strict_intersect or not both_ends:
                for t, h in lhits.items():
                    orphans.append(
                        Hit(t, h.pos, h.fwd, h.mlen,
                            MateStatus.PAIRED_END_LEFT, read_len=len1)
                    )
                for t, h in rhits.items():
                    orphans.append(
                        Hit(t, h.pos, h.fwd, h.mlen,
                            MateStatus.PAIRED_END_RIGHT, read_len=len2)
                    )
                orphans.sort(key=lambda h: (h.txp, h.mate_status))
            if not opts.allow_orphans:
                orphans = []
            joint = orphans

        num_joint = len(joint)
        if num_joint > opts.max_read_occs or overflow:
            joint = []
            num_joint = 0  # reference clears jointHits (:217); a
            # capacity overflow drops the fragment the same way
            # (device kernel parity, see _mmps)

        return self._collapse(joint, expected, paired_end=True)

    def map_fragment_se(
        self, read: np.ndarray, expected: LibraryFormat
    ) -> ReadMapping:
        hits, overflow = self.map_single_oriented(read)
        joint = [
            Hit(t, h.pos, h.fwd, h.mlen, MateStatus.SINGLE_END, read_len=len(read))
            for t, h in sorted(hits.items())
        ]
        if len(joint) > self.opts.max_read_occs or overflow:
            joint = []
        return self._collapse(joint, expected, paired_end=False)

    def _collapse(
        self, joint: list[Hit], expected: LibraryFormat, paired_end: bool
    ) -> ReadMapping:
        """Library-compat filtering and eq-class label formation, mirroring
        the per-read tail of processReadsQuasi
        (src/SailfishQuantify.cpp:248-434)."""
        opts = self.opts
        compat_ids: list[int] = []
        all_ids: list[int] = []
        fw_compat = rc_compat = fw_all = rc_all = 0
        have_compat = False
        first_fmt_compat = first_fmt_all = -1

        for h in joint:
            if h.mate_status == MateStatus.PAIRED_END_PAIRED:
                end1 = h.pos if h.fwd else h.pos + h.read_len
                end2 = h.mate_pos if h.mate_fwd else h.mate_pos + h.mate_len
                observed = hit_type(
                    end1, h.fwd, h.read_len, end2, h.mate_fwd, h.mate_len,
                    opts.allow_dovetail,
                )
                compat = opts.ignore_lib_compat or compatible_hit_paired(
                    expected, observed
                )
                fwd_hit = h.fwd
            else:
                compat = opts.ignore_lib_compat or compatible_hit_single(
                    expected, h.fwd, h.mate_status
                )
                if h.mate_status == MateStatus.PAIRED_END_LEFT:
                    fwd_hit = h.fwd
                elif h.mate_status == MateStatus.PAIRED_END_RIGHT:
                    fwd_hit = not h.fwd
                else:
                    fwd_hit = h.fwd
                # orphans/SE hits observe as SE SF/SR by hit orientation
                observed = LibraryFormat(
                    ReadType.SINGLE_END, ReadOrientation.NONE,
                    ReadStrandedness.S if fwd_hit else ReadStrandedness.A,
                )
            if compat:
                have_compat = True
                compat_ids.append(h.txp)
                if first_fmt_compat < 0:
                    first_fmt_compat = observed.format_id()
                if fwd_hit:
                    fw_compat += 1
                else:
                    rc_compat += 1
            if not have_compat and not opts.enforce_lib_compat:
                all_ids.append(h.txp)
                if first_fmt_all < 0:
                    first_fmt_all = observed.format_id()
                if fwd_hit:
                    fw_all += 1
                else:
                    rc_all += 1

        if have_compat and compat_ids:
            label = tuple(compat_ids)
            nf, nr = fw_compat, rc_compat
            fmt_id = first_fmt_compat
        elif all_ids:
            label = tuple(all_ids)
            nf, nr = fw_all, rc_all
            fmt_id = first_fmt_all
        else:
            label, nf, nr, fmt_id = None, 0, 0, -1

        unique_paired = (
            len(joint) == 1
            and joint[0].mate_status == MateStatus.PAIRED_END_PAIRED
            and label is not None
        )
        frag_len = joint[0].frag_len if unique_paired else 0
        return ReadMapping(
            label=label,
            num_joint_hits=len(joint),
            frag_len=frag_len,
            unique_paired=unique_paired,
            num_fwd=nf,
            num_rc=nr,
            fmt_id=fmt_id,
            compat=bool(have_compat and compat_ids),
            joint=joint,
        )
