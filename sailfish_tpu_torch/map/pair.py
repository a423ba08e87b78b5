"""Orientation merge, paired-end merge, library-compat filtering,
eq-class label formation and within-batch label collapse.

Counterpart of sailfish_tpu/map/pair.py (`merge_and_collapse`,
`_hash_labels`, `_se_compat_bits`, `_pe_compat`, `collapse_unique`),
paired-end and single-end libraries.  Same static shapes: per fragment
the joint-hit slots are 4C wide (read 1 fw/rc, read 2 fw/rc), 2C for a
single-end read.  The label hashes h1/h2 are bit-equal to the JAX
package's, so both packages' HashedEqClassAccumulator key classes alike
on (h1 << 32) | h2.
"""

from __future__ import annotations

import torch

from ..bits import M32, mix32, mul32, to_i32

NEG = 2**31 - 1
PAD = -1
PAIRED, LEFT, RIGHT, SINGLE = 0, 1, 2, 3

_H1_INIT = 2166136261        # FNV-1a offset basis
_H1_PRIME = 16777619         # FNV prime
_H2_INIT = 0x9E3779B9
_H2_PRIME = 0x85EBCA6B


def _shift_fwd(a, d, fill):
    """a[:, j+d] with out-of-range slots filled."""
    pad = torch.full((a.shape[0], d), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a[:, d:], pad], dim=1)


def _shift_back(a, d, fill):
    """a[:, j-d] with out-of-range slots filled."""
    pad = torch.full((a.shape[0], d), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:, :a.shape[1] - d]], dim=1)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 by halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def hash_labels(label: torch.Tensor, count: torch.Tensor):
    """Two 32-bit hashes of each compacted label row (PAD ignored, length
    mixed in); int64 tensors in [0, 2**32)."""
    W = label.shape[1]
    live = label != PAD
    xu = (label.to(torch.int64) + 1) & M32
    j = torch.arange(W, dtype=torch.int64, device=label.device)[None, :]
    m1 = mix32(xu ^ mul32(j, _H1_PRIME) ^ _H1_INIT)
    m2 = mix32((xu + mul32(j, _H2_PRIME) + _H2_INIT) & M32)
    h1 = _xor_reduce(torch.where(live, m1, 0))
    h2 = torch.where(live, m2, 0).sum(dim=1) & M32
    cu = count.to(torch.int64) & M32
    h1 = mix32(mul32(h1 ^ cu, _H1_PRIME))
    h2 = mix32(mul32((h2 + cu) & M32, _H2_PRIME))
    return h1, h2


def se_compat_bits(se_flags, status, fwd, ignore: bool):
    """Orphan / single-end compatibility from the 6 precomputed flags
    (left fw/rc, right fw/rc, single fw/rc)."""
    lf, lr, rf, rr, sf, sr = (bool(x) for x in se_flags)
    t = torch.tensor(True, device=fwd.device)
    f = torch.tensor(False, device=fwd.device)

    def pick(a, b):
        return torch.where(fwd, t if a else f, t if b else f)

    compat = torch.where(
        status == LEFT, pick(lf, lr),
        torch.where(status == RIGHT, pick(rf, rr), pick(sf, sr)))
    return compat | ignore


def pe_compat(pos1, fwd1, len1, pos2, fwd2, len2, exp_orientation: int,
              exp_strandedness: int, allow_dovetail: bool, ignore: bool):
    """hit_type + compatible_hit_paired, vectorized.  Orientation codes
    SAME=0, AWAY=1, TOWARD=2; strandedness SA=0, AS=1, S=2, A=3, U=4.
    Returns (compat, obs_orient, obs_strand)."""
    end1 = torch.where(fwd1, pos1, pos1 + len1)
    end2 = torch.where(fwd2, pos2, pos2 + len2)
    opp = fwd1 != fwd2
    stretch1 = len2 if allow_dovetail else torch.zeros_like(len2)
    stretch2 = len1 if allow_dovetail else torch.zeros_like(len1)
    toward = torch.where(fwd1, end1 <= end2 + stretch1,
                         end2 <= end1 + stretch2)
    obs_orient = torch.where(opp, torch.where(toward, 2, 1), 0)
    obs_strand = torch.where(opp, torch.where(fwd1, 0, 1),
                             torch.where(fwd1, 2, 3))
    compat = (obs_orient == exp_orientation) & (
        (exp_strandedness == 4) | (obs_strand == exp_strandedness))
    return compat | ignore, obs_orient, obs_strand


def merge_and_collapse(hits1_fw, hits1_rc, hits2_fw, hits2_rc, lens1, lens2,
                       exp_orientation: int, exp_strandedness: int,
                       se_flags, *, paired_end: bool = True,
                       cand_cap: int, max_read_occs: int,
                       allow_orphans: bool, allow_dovetail: bool,
                       ignore_compat: bool, enforce_compat: bool,
                       strict_intersect: bool = False,
                       return_slots: bool = False) -> dict:
    """Fragment-level merge + label formation (the oriented hit blocks —
    four for a paired-end fragment, read 1's two for a single-end read,
    whose hits2/lens2 arguments are ignored — are merged by one sort on
    (txp, side, orient); orientation resolution and mate pairing are
    neighbour tests in that order).  Returns per-fragment tensors: label
    (B, W) int32, W = 4C paired-end or 2C single-end
    (PAD-filled), label_len, h1/h2 (int64 holding uint32), mapped,
    num_joint, unique_paired, frag_len, num_fwd, num_rc, overflow,
    fmt_id, have_compat.  With `return_slots`, also "slots": the (B, W)
    joint-hit slot tensors the bias model observes (stats/bias.py
    `bias_observe`): txp, pos, fwd, mpos, mfwd, status, valid, frag_len,
    and the per-fragment mapped; mpos / mfwd are zeros for single-end."""
    C = cand_cap
    B = hits1_fw["txp"].shape[0]
    dev = hits1_fw["txp"].device
    NOKEY = -2
    rc1_wins = hits1_rc["mlen"] > hits1_fw["mlen"]
    if paired_end:
        rc2_wins = hits2_rc["mlen"] > hits2_fw["mlen"]
        blocks = (hits1_fw, hits1_rc, hits2_fw, hits2_rc)
        sides = (0, 0, 1, 1)
        orients = (0, 1, 0, 1)
    else:
        rc2_wins = rc1_wins
        blocks = (hits1_fw, hits1_rc)
        sides = (0, 0)
        orients = (0, 1)
    W = C * len(blocks)

    txp0 = torch.cat([b["txp"] for b in blocks], dim=1)
    pos0 = torch.cat([b["pos"] for b in blocks], dim=1)
    valid0 = torch.cat([b["valid"] for b in blocks], dim=1)
    slot_so = torch.tensor([2 * s + o for s, o in zip(sides, orients)],
                           device=dev).repeat_interleave(C)
    overflow = blocks[0]["overflow"]
    for b in blocks[1:]:
        overflow = overflow | b["overflow"]

    # one sort groups each transcript's (<= 4) slots as
    # [L-fw, L-rc, R-fw, R-rc]; invalid slots sink to the back
    key0 = torch.where(valid0, txp0, NEG).to(torch.int64)
    order = (key0 * 4 + slot_so).sort(dim=1, stable=True).indices
    txp = key0.gather(1, order).to(torch.int32)
    so = slot_so.expand(B, W).gather(1, order)
    side = so >> 1
    fwd = (so & 1) == 0
    pos = pos0.gather(1, order)
    valid = valid0.gather(1, order)

    # orientation resolution: a (txp, side) pair hit in both orientations
    # occupies adjacent slots (fw first); drop the loser
    same_ts_next = (
        valid & _shift_fwd(valid, 1, False)
        & (txp == _shift_fwd(txp, 1, NOKEY))
        & (side == _shift_fwd(side, 1, -1))
    )
    dup_prev = _shift_back(same_ts_next, 1, False)
    rcw = torch.where(side == 0, rc1_wins[:, None], rc2_wins[:, None])
    keep = (valid & torch.where(same_ts_next, ~rcw, True)
            & torch.where(dup_prev, rcw, True))

    if paired_end:
        l1 = lens1.to(torch.int32)[:, None].expand(B, W)
        l2 = lens2.to(torch.int32)[:, None].expand(B, W)
        # pairing: a kept left slot's kept right partner (same txp) sits
        # 1..3 slots ahead
        paired_l = torch.zeros((B, W), dtype=torch.bool, device=dev)
        mate_pos = torch.zeros((B, W), dtype=torch.int32, device=dev)
        mate_fwd = torch.zeros((B, W), dtype=torch.bool, device=dev)
        for d in (1, 2, 3):
            kd = (keep & (side == 0) & _shift_fwd(keep, d, False)
                  & (txp == _shift_fwd(txp, d, NOKEY))
                  & (_shift_fwd(side, d, 0) == 1))
            new = kd & ~paired_l
            mate_pos = torch.where(new, _shift_fwd(pos, d, 0), mate_pos)
            mate_fwd = torch.where(new, _shift_fwd(fwd, d, False), mate_fwd)
            paired_l = paired_l | kd
        ap = paired_l.any(dim=1)[:, None]

        orphans = keep if allow_orphans else torch.zeros_like(keep)
        if not strict_intersect:
            left_has = (keep & (side == 0)).any(dim=1)
            right_has = (keep & (side == 1)).any(dim=1)
            orphans = orphans & ~(left_has & right_has)[:, None]
        valid = torch.where(ap, paired_l, orphans)
        status = torch.where(ap, PAIRED, torch.where(side == 0, LEFT, RIGHT))
        mpos = torch.where(ap & paired_l, mate_pos, 0)
        mfwd = ap & paired_l & mate_fwd

        is_p = status == PAIRED
        pe_ok, obs_o, obs_s = pe_compat(pos, fwd, l1, mpos, mfwd, l2,
                                        exp_orientation, exp_strandedness,
                                        allow_dovetail, ignore_compat)
        se_ok = se_compat_bits(se_flags, status, fwd, ignore_compat)
        compat = torch.where(is_p, pe_ok, se_ok)
        fwd_hit = torch.where(status == RIGHT, ~fwd, fwd)
        pe_fmt = 1 | (obs_o << 1) | (obs_s << 3)
        se_fmt = (3 << 1) | (torch.where(fwd_hit, 2, 3) << 3)
        slot_fmt = torch.where(is_p, pe_fmt, se_fmt)
        slot_fraglen = (torch.maximum(pos + l1, mpos + l2)
                        - torch.minimum(pos, mpos))
    else:
        valid = keep
        status = torch.full((B, W), SINGLE, dtype=torch.int64, device=dev)
        compat = se_compat_bits(se_flags, status, fwd, ignore_compat)
        fwd_hit = fwd
        is_p = torch.zeros((B, W), dtype=torch.bool, device=dev)
        slot_fraglen = torch.zeros((B, W), dtype=torch.int32, device=dev)
        mpos = torch.zeros((B, W), dtype=torch.int32, device=dev)
        mfwd = torch.zeros((B, W), dtype=torch.bool, device=dev)
        slot_fmt = (3 << 1) | (torch.where(fwd_hit, 2, 3) << 3)

    num_joint = valid.sum(dim=1)
    too_many = (num_joint > max_read_occs) | overflow
    valid = valid & ~too_many[:, None]
    num_joint = torch.where(too_many, 0, num_joint)

    compat = compat & valid
    have_compat = compat.any(dim=1)
    selected = valid & torch.where(have_compat[:, None], compat,
                                   not enforce_compat)
    mapped = selected.any(dim=1)
    num_fwd = (selected & fwd_hit).sum(dim=1)
    num_rc = (selected & ~fwd_hit).sum(dim=1)

    fsel = selected.to(torch.uint8).argmax(dim=1, keepdim=True)
    fmt_id = torch.where(mapped, slot_fmt.gather(1, fsel)[:, 0], -1)

    # compact selected txps left in ascending txp order (stable: left-read
    # hits before right-read hits)
    label = torch.where(selected, txp, NEG).sort(dim=1, stable=True).values
    label = torch.where(label == NEG, PAD, label)
    label_len = selected.sum(dim=1)

    # the lone joint hit's slot (num_joint == 1 when this matters);
    # single-end: is_p is all False, so no fragment is unique-paired
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    unique_paired = (num_joint == 1) & is_p.gather(1, first)[:, 0] & mapped
    frag_len = torch.where(unique_paired,
                           slot_fraglen.gather(1, first)[:, 0], 0)

    h1, h2 = hash_labels(label, label_len)
    h1 = torch.where(mapped, h1, M32)
    h2 = torch.where(mapped, h2, M32)
    out = {
        "label": label,
        "label_len": label_len,
        "h1": h1,
        "h2": h2,
        "mapped": mapped,
        "num_joint": num_joint,
        "unique_paired": unique_paired,
        "frag_len": frag_len,
        "num_fwd": num_fwd,
        "num_rc": num_rc,
        "overflow": overflow,
        "fmt_id": fmt_id,
        "have_compat": have_compat & mapped,
    }
    if return_slots:
        out["slots"] = {
            "txp": txp, "pos": pos, "fwd": fwd, "mpos": mpos, "mfwd": mfwd,
            "status": status, "valid": valid, "frag_len": slot_fraglen,
            "mapped": mapped,
        }
    return out


def collapse_unique(h1, h2, mapped, label_len):
    """Within-batch collapse of identical label hashes.  Returns (uniq, U):
    uniq (B, 5) int32 rows [h1, h2, count, rep_orig_idx, label_len] (the
    hashes as int32 bit patterns), the U live classes first, sorted by
    unsigned (h1, h2); U a 0-dim tensor."""
    B = h1.shape[0]
    dev = h1.device
    # unsigned (h1, h2) order as one signed int64 key
    key = (h1 - 2**31) * 2**32 + h2
    order = key.sort(stable=True).indices
    sh1, sh2 = h1[order], h2[order]
    smapped = mapped[order]
    slen = label_len[order].to(torch.int32)
    newgrp = torch.ones(B, dtype=torch.bool, device=dev)
    newgrp[1:] = (sh1[1:] != sh1[:-1]) | (sh2[1:] != sh2[:-1])
    gid = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    counts = torch.zeros(B, dtype=torch.int32, device=dev).index_add_(
        0, gid, smapped.to(torch.int32))
    group_count = counts[gid]
    is_first = newgrp & smapped
    perm = (~is_first).to(torch.uint8).sort(stable=True).indices
    uniq = torch.stack([
        to_i32(sh1[perm]), to_i32(sh2[perm]), group_count[perm],
        order[perm].to(torch.int32), slen[perm],
    ], dim=1)
    return uniq, is_first.sum()
