"""The scan taken apart for a sharded index: per-position facts on each
shard, a merge across shards, a replay of the advance rule, and the
slots of the replayed MMPs on each shard.

Counterpart of the lockstep scan that sailfish_tpu/map/kernels.py
`map_oriented_lanes(axis_name=...)` runs under shard_map: there each
scan step reduces three per-lane values over the mesh (the largest LCP,
the interval size for the overflow rule, whether any shard found the
seed; `scan_step`) and the prefix seed two more (`seed_prefix`'s
`gsum`).  The scan state enters a step only through `active` and `nm`,
so those values are facts of a (lane, position) that do not depend on
the state, and the scan can be replayed from them:

  1. facts (`scan_facts`): on each shard, for every position of every
     lane: k-mer route, the k-mer's count (-1 when not found) and the
     largest LCP of its candidates when 0 < count <= C; prefix route,
     first the interval sizes at each refinement level (`prefix_sizes`),
     then, at the level the merged sizes chose (`FactsMerge.levels`),
     the largest LCP;
  2. merge (`FactsMerge`): any, sum and max over the shards (the JAX
     collectives).  When the summed size is at most C each shard's size
     is too, so its local maximum covers all of its candidates.  The
     merged fact of a position (`gfact`) is OVERFLOW, or the largest LCP
     over all shards (-1 for a miss);
  3. replay (`replay`): per lane, the sequential advance rule over
     `gfact`: step budget, overflow, MMP count, the first MMP's length,
     and each MMP's position and length;
  4. slots (`scan_slots`): on each shard, the seed and the compare again
     at the replayed MMPs only, written as the scan writes its slots
     (map/scan.py), transcript ids moved by the shard's base, valid when
     the LCP equals the merged length.  A shard without such a candidate
     still gets the MMP's slots, all invalid: with disjoint transcripts
     that keeps the post-pass's intersection exact per shard.

Each of `scan_facts`, `replay` and `scan_slots` dispatches on the
device: a CUDA tensor launches its kernel (csrc/mmp_scan.cu facts, replay
and slot modes) and counts the launch; a CPU tensor runs the plain torch
version beside it.  A kernel build or launch failure raises.
"""

from __future__ import annotations

import torch

from ..bits import u32
from ..index.device import TorchIndex
from .scan import (
    _check,
    _clean,
    _coarse,
    _lcp,
    _probe,
    _counter,
    _refine,
    card_lanes,
    clean_counts,
    needed_chunks,
)

OVERFLOW = -2          # merged fact: the interval holds more than C
NO_REFINE = -2**31     # prefix sizes: no refinement possible there


# ---------------------------------------------------------------- facts
def scan_facts(lanes: dict, index: TorchIndex, *, cand_cap: int,
               level: torch.Tensor | None = None) -> torch.Tensor:
    """The facts of every position of every lane on one shard: int32
    (B2, L, 2) on the k-mer route, (B2, L, 4) on the prefix route's first
    pass (`level` None), (B2, L) on its second (see the module
    docstring); -1 (and NO_REFINE) where the position is not probed."""
    if lanes["codes"].device.type == "cuda":
        return facts_cuda(lanes, index, cand_cap=cand_cap, level=level)
    return facts_reference(lanes, index, cand_cap=cand_cap, level=level)


def _level_arg(index, level, B2, L, dev):
    if level is None:
        return None
    if not index.prefix_route:
        raise ValueError("a level is given on the prefix route only")
    if level.shape != (B2, L) or level.dtype != torch.int8 \
            or level.device != dev:
        raise ValueError(f"level must be int8 ({B2}, {L}) on {dev}")
    return level.contiguous()


def _facts_shape(index, level, B2, L):
    if not index.prefix_route:
        return (B2, L, 2)
    return (B2, L, 4) if level is None else (B2, L)


def _seed_args(index):
    """The table arguments the facts and slot entries take: (ht, ht_hi,
    table_lo, packed, P, ht_bits, ht_probes), null where the route has
    none."""
    def ptr(t):
        return None if t is None else t.data_ptr()
    return (ptr(index.ht), ptr(index.ht_hi), ptr(index.table_lo),
            ptr(index.packed), index.prefix_bases, index.ht_bits,
            index.ht_probes)


def facts_cuda(lanes, index, *, cand_cap, level=None, chunks_read=None):
    """Launch the facts mode (`sf_mmp_facts`) on the lanes' CUDA device;
    `facts_cuda.launches` counts successful launches.  `chunks_read`, when
    given, is a one-element int64 tensor on the device to which the kernel
    adds the 16-byte text chunks its compare reads (`work["chunks"]` of
    the plain version counts those needed)."""
    from .. import _ext

    dev, B2, L, (codes, pw, lens) = card_lanes(lanes, index, cand_cap, 1,
                                               "facts_cuda")
    level = _level_arg(index, level, B2, L, dev)
    chunks_ptr = _counter(chunks_read, dev, "chunks_read")
    kl = _ext.load()
    out = torch.empty(_facts_shape(index, level, B2, L), dtype=torch.int32,
                      device=dev)
    ht, ht_hi, table_lo, packed, pbits, ht_bits, ht_probes = \
        _seed_args(index)
    err = kl.lib.sf_mmp_facts(
        int(index.pos_bits == 64), int(index.prefix_route),
        codes.data_ptr(), pw.data_ptr(), lens.data_ptr(), B2, L,
        index.codes.data_ptr(), index.codes.numel(), index.sa.data_ptr(),
        ht, ht_hi, table_lo, packed, pbits, index.k, cand_cap, ht_bits,
        ht_probes, None if level is None else level.data_ptr(),
        out.data_ptr(), chunks_ptr, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    kl.check(err, "facts kernel launch")
    facts_cuda.launches += 1
    return out


facts_cuda.launches = 0


def _live_pairs(lanes, k):
    """(lane, p) of every probed position: p + k <= len."""
    codes = lanes["codes"]
    B2, L = codes.shape
    j = torch.arange(L, device=codes.device)
    live = j[None, :] + k <= lanes["lens"].to(torch.int64)[:, None]
    lane, p = live.nonzero(as_tuple=True)
    return lane, p


def _largest_lcp(lanes, index, lane, p, lo, cnt, work):
    """Per pair, the largest LCP of its cnt candidates sa[lo, lo + cnt)
    (-1 for none)."""
    codes, lens = lanes["codes"], lanes["lens"].to(torch.int64)
    n = lane.numel()
    own = torch.repeat_interleave(torch.arange(n, device=lane.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    c = torch.arange(own.numel(), device=lane.device) - start[own]
    g = index.sa.long()[lo[own] + c]
    lcp = _lcp(codes, lens, index.codes, lane[own], p[own], g).long()
    if work is not None:
        rem = lens[lane[own]] - p[own]
        work["candidates"] += own.numel()
        work["text_bytes"] += int(lcp.sum() + (lcp < rem).sum())
        work["chunks"] += int(needed_chunks(lcp, rem).sum())
    best = torch.full((n,), -1, dtype=torch.int64, device=lane.device)
    best.scatter_reduce_(0, own, lcp, reduce="amax")
    return best, own, c, g, lcp


def prefix_sizes(index, pw, cb, lens, lane, p, reads):
    """The prefix route's first facts pass at each (lane, p) pair:
    int64 (n, 4) of the coarse size (-1 when the first P bases hold an
    N), then nhi - nlo of the depth-0 refinement, of the depth-16
    refinement of the coarse interval and of the depth-0 one, NO_REFINE
    where the lane has no 16 clean bases at that depth."""
    n = lane.numel()
    f = torch.full((n, 4), NO_REFINE, dtype=torch.int64, device=lane.device)
    pvalid = _clean(cb, lane, p, index.prefix_bases)
    lo, hi = _coarse(index, pw, lane, p)
    f[:, 0] = torch.where(pvalid, hi - lo, -1)
    ln = lens[lane]
    d0 = pvalid & (p + 16 <= ln) & _clean(cb, lane, p, 16)
    d1 = pvalid & (p + 32 <= ln) & _clean(cb, lane, p + 16, 16)
    lo0, hi0 = lo.clone(), hi.clone()
    ix = d0.nonzero()[:, 0]
    if ix.numel():
        f[ix, 1], lo0[ix], hi0[ix] = _refine(index, pw, lane[ix], p[ix], 0,
                                             lo[ix], hi[ix], reads)
    ix = d1.nonzero()[:, 0]
    if ix.numel():
        f[ix, 2] = _refine(index, pw, lane[ix], p[ix], 16, lo[ix], hi[ix],
                           reads)[0]
        f[ix, 3] = f[ix, 2]
        jx = ix[d0[ix]]
        if jx.numel():
            f[jx, 3] = _refine(index, pw, lane[jx], p[jx], 16, lo0[jx],
                               hi0[jx], reads)[0]
    return f.clamp(max=2**31 - 1)


def at_level(index, pw, lane, p, level, reads):
    """The prefix route's interval at each pair's refinement level (bit
    0: depth 0, bit 1: then depth 16): (lo, cnt) int64."""
    lo, hi = _coarse(index, pw, lane, p)
    for bit, depth in ((1, 0), (2, 16)):
        ix = ((level & bit) != 0).nonzero()[:, 0]
        if ix.numel():
            _, lo[ix], hi[ix] = _refine(index, pw, lane[ix], p[ix], depth,
                                        lo[ix], hi[ix], reads)
    return lo, hi - lo


def facts_reference(lanes, index, *, cand_cap, level=None,
                    work: dict | None = None):
    """Plain torch version of the facts mode, over every (lane, position)
    pair at once; same output as the kernel.  `work`, when given, receives
    the data-dependent terms of the kernel's bound, with the keys of
    map/scan.py `mmp_scan_reference`'s ("buckets" or "lookups" and
    "search_steps", "candidates", "text_bytes", "chunks")."""
    _check(lanes, index, cand_cap, 1)
    codes, pw = lanes["codes"], lanes["pw"]
    lens = lanes["lens"].to(torch.int64)
    dev = codes.device
    B2, L = codes.shape
    k, C = index.k, cand_cap
    if work is not None:
        work.update(candidates=0, text_bytes=0, chunks=0)
    lane, p = _live_pairs(lanes, k)
    shape = _facts_shape(index, level, B2, L)
    if index.prefix_route:
        reads = torch.zeros(2, dtype=torch.int64, device=dev)
        cb = clean_counts(codes)
        if level is None:
            out = torch.full(shape, NO_REFINE, dtype=torch.int32, device=dev)
            out[..., 0] = -1
            out[lane, p] = prefix_sizes(index, pw, cb, lens, lane, p,
                                        reads).to(torch.int32)
            if work is not None:
                work.update(lookups=int(_clean(cb, lane, p,
                                               index.prefix_bases).sum()),
                            search_steps=int(reads[1]))
            return out
        lv = level[lane, p].long()
        sel = (lv >= 0).nonzero()[:, 0]
        lane, p = lane[sel], p[sel]
        lo, cnt = at_level(index, pw, lane, p, lv[sel], reads)
        if work is not None:
            work.update(lookups=int(sel.numel()), search_steps=int(reads[1]))
        found = torch.ones_like(lane, dtype=torch.bool)
    else:
        key0 = u32(pw[lane, p])
        key1 = u32(pw[lane, p + 16]) >> (2 * (32 - k))
        found, lo, cnt, nb = _probe(index, key0, key1, work is not None)
        if work is not None:
            work["buckets"] = int(nb)
    out = torch.full(shape, -1, dtype=torch.int32, device=dev)
    sel = (found & (cnt > 0) & (cnt <= C)).nonzero()[:, 0]
    best = _largest_lcp(lanes, index, lane[sel], p[sel], lo[sel], cnt[sel],
                        work)[0]
    if index.prefix_route:
        out[lane[sel], p[sel]] = best.to(torch.int32)
    else:
        out[lane, p, 0] = torch.where(found, cnt, -1).to(torch.int32)
        out[lane[sel], p[sel], 1] = best.to(torch.int32)
    return out


# ---------------------------------------------------------------- merge
class FactsMerge:
    """Facts folded over the shards one at a time, on the device of the
    first (a later shard's facts are moved there).  `add` takes a shard's
    facts pass; on the prefix route `levels` then chooses each position's
    refinement level, the second pass's facts are added with `add_lcp`,
    and `gfact` gives the merged facts the replay reads."""

    def __init__(self, *, k: int, cand_cap: int, prefix: bool):
        self.k, self.C, self.prefix = k, cand_cap, prefix
        self.n = 0
        self._lstar = None

    def add(self, facts: torch.Tensor) -> None:
        if self.n and facts.device != self._dev:
            facts = facts.to(self._dev)
        if not self.n:
            self._dev = facts.device
        f = facts.long()
        if self.prefix:
            self._add_sizes(f)
        else:
            cnt, lstar = f[..., 0], f[..., 1]
            self._fold("found", cnt >= 0, torch.logical_or)
            self._fold("size", cnt.clamp(min=0), torch.add)
            self._fold_lstar(lstar)
        self.n += 1

    def _fold(self, name, x, op):
        cur = getattr(self, name, None) if self.n else None
        setattr(self, name, x if cur is None else op(cur, x))

    def _fold_lstar(self, x):
        self._lstar = x if self._lstar is None else torch.maximum(
            self._lstar, x)

    def _add_sizes(self, f):
        c0, d0, d1c, d1r = f.unbind(-1)
        if not self.n:
            # lane-level facts, the same on every shard
            self.pvalid = c0 >= 0
            self.cond0 = d0 != NO_REFINE
            self.cond1 = d1c != NO_REFINE
        self._fold("s0", c0.clamp(min=0), torch.add)
        for name, d in (("r0", d0), ("r1c", d1c), ("r1r", d1r)):
            # the signed sum decides emptiness, the clamped one is the
            # size a shard adopts: [min(nlo, nhi), nhi)
            self._fold(name + "s", d, torch.add)
            self._fold(name + "p", d.clamp(min=0), torch.add)

    def levels(self) -> torch.Tensor:
        """The prefix route's refinement level of each position, from the
        merged sizes (map/kernels.py `seed_prefix` under a mesh): int8
        (B2, L), -1 where the second pass has nothing to compare (a miss,
        an empty interval or an overflow)."""
        C, k = self.C, self.k
        need0 = self.pvalid & self.cond0 & (self.s0 > C)
        empty0 = self.r0s <= 0
        proven = need0 & empty0 & (k >= 16)
        adopt0 = need0 & ~empty0
        size = torch.where(adopt0, self.r0p, self.s0)
        r1s = torch.where(adopt0, self.r1rs, self.r1cs)
        r1p = torch.where(adopt0, self.r1rp, self.r1cp)
        need1 = self.pvalid & self.cond1 & ~proven & (size > C)
        empty1 = r1s <= 0
        proven |= need1 & empty1 & (k >= 32)
        adopt1 = need1 & ~empty1
        size = torch.where(adopt1, r1p, size)
        may = self.pvalid & ~proven
        self.found, self.size = may, torch.where(may, size, 0)
        lv = adopt0.to(torch.int8) + 2 * adopt1.to(torch.int8)
        return torch.where(may & (size > 0) & (size <= C), lv, -1).to(
            torch.int8)

    def add_lcp(self, lstar: torch.Tensor) -> None:
        """A shard's second facts pass (prefix route)."""
        self._fold_lstar(lstar.to(self._dev).long())

    def gfact(self) -> torch.Tensor:
        """int32 (B2, L): OVERFLOW, or the largest LCP over all shards
        (-1 for a miss)."""
        over = self.found & (self.size > self.C)
        hit = self.found & (self.size > 0)
        return torch.where(over, OVERFLOW, torch.where(
            hit, self._lstar, -1)).to(torch.int32)


# --------------------------------------------------------------- replay
def replay(gfact, lens, *, k: int, max_mmps: int, max_steps: int,
           skip_jump: bool = False):
    """The sequential scan over merged facts: (hits, hit_len) int32 (B2,
    max_mmps), each MMP's position and length, -1 behind the last, and
    meta int32 (B2, 4) as the scan's (MMPs, overflow, first MMP's
    length, positions probed)."""
    if gfact.device.type == "cuda":
        return replay_cuda(gfact, lens, k=k, max_mmps=max_mmps,
                           max_steps=max_steps, skip_jump=skip_jump)
    return replay_reference(gfact, lens, k=k, max_mmps=max_mmps,
                            max_steps=max_steps, skip_jump=skip_jump)


def _replay_check(gfact, lens):
    if gfact.dim() != 2 or gfact.dtype != torch.int32 \
            or lens.shape != gfact.shape[:1] or lens.dtype != torch.int32 \
            or lens.device != gfact.device:
        raise ValueError("replay needs int32 gfact (B2, L) and int32 lens "
                         "(B2,) on one device")


def replay_cuda(gfact, lens, *, k, max_mmps, max_steps, skip_jump=False):
    """Launch the replay kernel (`sf_mmp_replay`), one thread a lane;
    `replay_cuda.launches` counts successful launches."""
    from .. import _ext

    _replay_check(gfact, lens)
    dev = gfact.device
    if dev.type != "cuda":
        raise ValueError(f"replay_cuda needs CUDA tensors (got {dev})")
    B2, L = gfact.shape
    gfact, lens = gfact.contiguous(), lens.contiguous()
    hits = torch.empty((B2, max_mmps), dtype=torch.int32, device=dev)
    hit_len = torch.empty_like(hits)
    meta = torch.empty((B2, 4), dtype=torch.int32, device=dev)
    kl = _ext.load()
    err = kl.lib.sf_mmp_replay(
        gfact.data_ptr(), lens.data_ptr(), B2, L, k, max_mmps, max_steps,
        int(skip_jump), hits.data_ptr(), hit_len.data_ptr(), meta.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    kl.check(err, "replay kernel launch")
    replay_cuda.launches += 1
    return hits, hit_len, meta


replay_cuda.launches = 0


def replay_reference(gfact, lens, *, k, max_mmps, max_steps,
                     skip_jump=False):
    """Plain torch version of the replay, vectorized over lanes: one round
    a step."""
    _replay_check(gfact, lens)
    dev = gfact.device
    B2, L = gfact.shape
    M = max_mmps
    lens = lens.long().clamp(max=L)
    i = torch.zeros(B2, dtype=torch.int64, device=dev)
    nm, steps, mlen = (torch.zeros_like(i) for _ in range(3))
    over = torch.zeros(B2, dtype=torch.bool, device=dev)
    hits = torch.full((B2, M), -1, dtype=torch.int32, device=dev)
    hit_len = torch.full_like(hits, -1)
    rows = torch.arange(B2, device=dev)
    for _ in range(max_steps):
        act = (i + k <= lens) & (nm < M)
        if not bool(act.any()):
            break
        x = gfact[rows, i.clamp(max=L - 1)].long()
        steps += act.long()
        over |= act & (x == OVERFLOW)
        hit = act & (x >= k)
        h = hit.nonzero()[:, 0]
        hits[h, nm[h]] = i[h].to(torch.int32)
        hit_len[h, nm[h]] = x[h].to(torch.int32)
        mlen = torch.where(hit & (nm == 0), x, mlen)
        nm += hit.long()
        adv = (x + 1) if skip_jump else (x - k + 1).clamp(min=1)
        i += torch.where(act, torch.where(hit, adv, 1), 0)
    meta = torch.stack([nm, over.long(), mlen, steps], dim=1)
    return hits, hit_len, meta.to(torch.int32)


# ---------------------------------------------------------------- slots
def scan_slots(lanes, index, hits, hit_len, meta, level, *, txp_base: int,
               cand_cap: int, max_mmps: int):
    """The slots of the replayed MMPs on one shard: (txp, pos, valid) as
    map/scan.py `mmp_scan`'s, with txp moved by `txp_base`.  `level` is
    the prefix route's (B2, L) refinement levels (None on the k-mer
    route)."""
    kw = dict(txp_base=txp_base, cand_cap=cand_cap, max_mmps=max_mmps)
    if lanes["codes"].device.type == "cuda":
        return slots_cuda(lanes, index, hits, hit_len, meta, level, **kw)
    return slots_reference(lanes, index, hits, hit_len, meta, level, **kw)


def _slots_inputs(lanes, index, hits, hit_len, meta, level, M):
    B2, L = lanes["codes"].shape
    dev = lanes["codes"].device
    for t, shape in ((hits, (B2, M)), (hit_len, (B2, M)), (meta, (B2, 4))):
        if t.shape != shape or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"replay outputs must be int32 {shape} on {dev}")
    if index.prefix_route and level is None:
        raise ValueError("the prefix route's slots need the levels")
    return _level_arg(index, level, B2, L, dev) if index.prefix_route \
        else None


def slots_cuda(lanes, index, hits, hit_len, meta, level, *, txp_base,
               cand_cap, max_mmps):
    """Launch the slot mode (`sf_mmp_slots`); `slots_cuda.launches` counts
    successful launches."""
    from .. import _ext

    dev, B2, L, (codes, pw, lens) = card_lanes(lanes, index, cand_cap,
                                               max_mmps, "slots_cuda")
    level = _slots_inputs(lanes, index, hits, hit_len, meta, level, max_mmps)
    hits, hit_len, meta = (t.contiguous() for t in (hits, hit_len, meta))
    C, M = cand_cap, max_mmps
    txp = torch.empty((B2, M * C), dtype=torch.int32, device=dev)
    pos = torch.empty_like(txp)
    vld = torch.empty((B2, M * C), dtype=torch.uint8, device=dev)
    ht, ht_hi, table_lo, packed, pbits, ht_bits, ht_probes = \
        _seed_args(index)
    kl = _ext.load()
    err = kl.lib.sf_mmp_slots(
        int(index.pos_bits == 64), int(index.prefix_route),
        codes.data_ptr(), pw.data_ptr(), lens.data_ptr(), B2, L,
        index.codes.data_ptr(), index.codes.numel(), index.sa.data_ptr(),
        ht, ht_hi, table_lo, packed, pbits, index.txp_of_pos.data_ptr(),
        index.txp_offsets.data_ptr(), int(txp_base), index.k, C, M, ht_bits,
        ht_probes, None if level is None else level.data_ptr(),
        hits.data_ptr(), hit_len.data_ptr(), meta.data_ptr(), txp.data_ptr(),
        pos.data_ptr(), vld.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    kl.check(err, "slots kernel launch")
    slots_cuda.launches += 1
    return txp, pos, vld.view(torch.bool)


slots_cuda.launches = 0


def slots_reference(lanes, index, hits, hit_len, meta, level, *, txp_base,
                    cand_cap, max_mmps, work: dict | None = None):
    """Plain torch version of the slot mode; same outputs as the kernel.
    `work`, when given, receives the data-dependent terms of the kernel's
    bound as `facts_reference` gives them, and "stored" (candidates
    written, each reading `txp_of_pos` and `txp_offsets`)."""
    _check(lanes, index, cand_cap, max_mmps)
    level = _slots_inputs(lanes, index, hits, hit_len, meta, level, max_mmps)
    codes, pw = lanes["codes"], lanes["pw"]
    dev = codes.device
    B2, _ = codes.shape
    C, M = cand_cap, max_mmps
    txp = torch.zeros((B2, M * C), dtype=torch.int32, device=dev)
    pos = torch.zeros_like(txp)
    vld = torch.zeros((B2, M * C), dtype=torch.bool, device=dev)
    m_ix = torch.arange(M, device=dev)
    lane, m = (m_ix[None, :] < meta[:, :1].long()).nonzero(as_tuple=True)
    p = hits[lane, m].long()
    reads = torch.zeros(2, dtype=torch.int64, device=dev)
    if work is not None:
        work.update(candidates=0, text_bytes=0, chunks=0)
    if index.prefix_route:
        lo, cnt = at_level(index, pw, lane, p, level[lane, p].long(), reads)
        if work is not None:
            work.update(lookups=lane.numel(), search_steps=int(reads[1]))
    else:
        found, lo, cnt, nb = _probe(
            index, u32(pw[lane, p]),
            u32(pw[lane, p + 16]) >> (2 * (32 - index.k)), work is not None)
        cnt = torch.where(found, cnt, 0)
        if work is not None:
            work["buckets"] = int(nb)
    cnt = cnt.clamp(max=C)
    _, own, c, g, lcp = _largest_lcp(lanes, index, lane, p, lo, cnt, work)
    if work is not None:
        work["stored"] = own.numel()
    lo_lane, col = lane[own], m[own] * C + c
    tx = index.txp_of_pos[g].long()
    txp[lo_lane, col] = (tx + txp_base).to(torch.int32)
    pos[lo_lane, col] = (g - index.txp_offsets[tx].long()
                         - p[own]).to(torch.int32)
    vld[lo_lane, col] = lcp == hit_len[lane, m][own].long()
    return txp, pos, vld
