"""The MMP scan: per oriented read lane, the bounded maximal-mappable-
prefix search against the k-mer table and suffix array.

Counterpart of sailfish_tpu/map/pallas_kernel.py `mmp_scan_pallas`
(the Pallas `_scan_kernel`) and of the scan loop of map/kernels.py
`map_oriented_lanes`.  `mmp_scan` dispatches on the lanes' device: a
CUDA tensor launches the hand-written kernel (csrc/mmp_scan.cu, through
`mmp_scan_cuda`, in the index's route); a CPU tensor runs
`mmp_scan_reference`, the plain torch version.  A CUDA tensor never
reaches the plain version, and a kernel build or launch failure raises.

Two seed routes, picked by the index.  An index with a k-mer table
(17 <= k <= 31) probes it with the A-substituted k-mer at each position.
One without (k < 17) takes the XLA kernel's prefix-table seed
(map/kernels.py `seed_prefix`, `_search_bound`): the interval of the
position's P-base prefix, unless the first P bases hold an N, narrowed by
binary searches over the packed 16-base words at depths 0 and 16 while
it holds more than C suffixes and the read has 16 clean bases there; an
empty narrowing proves a miss when its depth covers k bases, and
otherwise leaves the interval as it was.  The candidates' LCPs count from
the first base in both routes.

Outputs, per lane (B2 lanes, C = cand_cap, M = max_mmps):
  txp, pos  int32 (B2, M*C)  slot m*C + c: candidate c of MMP m — its
                             transcript and in-transcript position minus
                             the query offset i of that MMP
  valid     bool  (B2, M*C)  candidate achieved the MMP length lstar
  meta      int32 (B2, 4)    [n_mmps, overflow, mlen (first MMP's lstar),
                              probed positions]
  stamps    int32 (B2, M+1)  with `stamps=True` only: the step at which
                             MMP m was recorded, -1 for those not found;
                             slot M the step of the first overflow, or -1
Slots that hold no candidate (behind an MMP's cnt candidates, and all
slots of MMPs a lane did not find) are zero; the kernel writes them
itself, so its buffers start uninitialised.  A lane is active at step s
exactly when s < meta[:, 3]; with the stamps that fixes its state before
every step, which the compacted scan (map/shrink.py) reads.  Slot order
within an MMP follows the suffix array; the post-pass (map/postpass.py)
canonicalizes.
The index text carries trailing padding (index/device.py TEXT_PAD): the
kernel's 16-byte text compare may read it, and the plain version clamps
into it, where code 4 ends a match as the final separator does.
"""

from __future__ import annotations

import torch

from ..bits import mix_kmer, to_i32, u32
from ..index.device import TorchIndex


def _check(lanes: dict, index: TorchIndex, cand_cap: int, max_mmps: int):
    codes, pw, lens = lanes["codes"], lanes["pw"], lanes["lens"]
    if codes.dtype != torch.uint8 or pw.dtype != torch.int32 \
            or lens.dtype != torch.int32:
        raise TypeError("lanes need uint8 codes, int32 pw and int32 lens")
    if codes.dim() != 2 or pw.shape != codes.shape \
            or lens.shape != codes.shape[:1]:
        raise ValueError("lane arrays disagree in shape")
    lo_k = index.prefix_bases if index.prefix_route else 17
    if not (lo_k <= index.k <= 31):
        raise ValueError(f"the scan needs {lo_k} <= k <= 31 on this index "
                         f"(got {index.k})")
    if cand_cap < 1 or max_mmps < 1:
        raise ValueError("cand_cap and max_mmps must be positive")
    for t in (codes, pw, lens):
        if t.device != index.device:
            raise ValueError(
                f"lanes on {t.device} but the index is on {index.device}")


def mmp_scan(lanes: dict, index: TorchIndex, *, cand_cap: int,
             max_mmps: int, max_steps: int, skip_jump: bool = False,
             stamps: bool = False):
    """Scan every lane; returns (txp, pos, valid, meta), and the step
    stamps behind them with `stamps`, as documented in the module
    docstring."""
    _check(lanes, index, cand_cap, max_mmps)
    dev = lanes["codes"].device
    kw = dict(cand_cap=cand_cap, max_mmps=max_mmps, max_steps=max_steps,
              skip_jump=skip_jump, stamps=stamps)
    if dev.type == "cuda":
        return mmp_scan_cuda(lanes, index, **kw)
    if dev.type == "cpu":
        return mmp_scan_reference(lanes, index, **kw)
    raise ValueError(f"unsupported device: {dev}")


def _outputs(B2: int, C: int, M: int, dev, out, stamps: bool):
    """The output tensors of a scan: fresh and uninitialised (the kernel
    writes every slot), or the caller's `out`, checked; a fifth, the
    step stamps, with `stamps`."""
    shapes = (((B2, M * C), torch.int32), ((B2, M * C), torch.int32),
              ((B2, M * C), torch.uint8), ((B2, 4), torch.int32))
    if stamps:
        shapes += (((B2, M + 1), torch.int32),)
    if out is None:
        return tuple(torch.empty(s, dtype=d, device=dev) for s, d in shapes)
    if len(out) != len(shapes):
        raise ValueError("out needs the tensors txp, pos, valid, meta"
                         + (" and stamps" if stamps else ""))
    for o, (s, d) in zip(out, shapes):
        if o.shape != s or o.dtype != d or o.device != dev \
                or not o.is_contiguous() or o.data_ptr() % 16:
            raise ValueError(
                f"out tensor {tuple(o.shape)} {o.dtype} on {o.device}: need "
                f"{s} {d} on {dev}, contiguous and 16-byte aligned")
    return tuple(out)


def card_lanes(lanes: dict, index: TorchIndex, cand_cap: int,
               max_mmps: int, what: str):
    """The checks of a kernel launch on the lanes' CUDA device: returns
    (device, B2, L, (codes, pw, lens) contiguous and 16-byte aligned: the
    kernels copy lane rows with 16-byte loads)."""
    _check(lanes, index, cand_cap, max_mmps)
    dev = lanes["codes"].device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors (got {dev})")
    B2, L = lanes["codes"].shape
    if L % 8:
        raise ValueError(f"the kernel needs a read width that is a multiple "
                         f"of 8 (got {L})")
    rows = tuple(
        t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
            memory_format=torch.contiguous_format)
        for t in (lanes["codes"], lanes["pw"], lanes["lens"]))
    return dev, B2, L, rows


def _counter(t: torch.Tensor | None, dev, name: str):
    """A measurement counter's pointer: one int64 on the lanes' device,
    or None."""
    if t is None:
        return None
    if t.dtype != torch.int64 or t.numel() != 1 or t.device != dev:
        raise ValueError(f"{name} must be one int64 on the lanes' device")
    return t.data_ptr()


def mmp_scan_cuda(lanes: dict, index: TorchIndex, *, cand_cap: int,
                  max_mmps: int, max_steps: int, skip_jump: bool = False,
                  stamps: bool = False, out=None,
                  rows_read: torch.Tensor | None = None,
                  chunks_read: torch.Tensor | None = None):
    """Launch csrc/mmp_scan.cu on the current stream of the lanes' CUDA
    device, in the index's route and width: `sf_mmp_scan` (or
    `sf_mmp_scan64` on a 64-bit index) through the k-mer table,
    `sf_mmp_scan_prefix` (or `sf_mmp_scan_prefix64`) through the prefix
    table of an index without one.  `mmp_scan_cuda.launches` counts
    successful launches of the k-mer route, `mmp_scan_cuda.prefix_launches`
    those of the prefix route; `mmp_scan_cuda.stamped_launches` those of
    either route that wrote stamps.

    `out`, when given, is four preallocated tensors (int32 txp and pos,
    uint8 valid, int32 meta) that the kernel fills instead of fresh ones;
    whatever they held is overwritten, every slot.  With `stamps` the
    kernel also writes the step stamps, a fifth output (and a fifth
    tensor of `out`, int32 (B2, M + 1)).
    `rows_read`, when given, is a one-element int64 tensor on the device
    to which the kernel adds the 64-byte table rows it reads, or on the
    prefix route the prefix-table lookups and binary-search steps (a
    measurement aid: it costs an atomic per probe window).
    `chunks_read`, the same on the prefix route only, receives the
    16-byte text chunks its compare reads (`work["chunks"]` of the plain
    version counts those needed)."""
    from .. import _ext

    dev, B2, L, (codes, pw, lens) = card_lanes(lanes, index, cand_cap,
                                               max_mmps, "mmp_scan_cuda")
    rows_ptr = _counter(rows_read, dev, "rows_read")
    chunks_ptr = _counter(chunks_read, dev, "chunks_read")
    if chunks_ptr is not None and not index.prefix_route:
        raise ValueError("chunks_read is counted on the prefix route only")
    kl = _ext.load()
    C, M = cand_cap, max_mmps
    outs = _outputs(B2, C, M, dev, out, stamps)
    txp, pos, vld, meta = outs[:4]
    stream = torch.cuda.current_stream(dev).cuda_stream
    wide = index.pos_bits == 64
    if index.prefix_route:
        scan = (kl.lib.sf_mmp_scan_prefix64 if wide
                else kl.lib.sf_mmp_scan_prefix)
        seed = (index.table_lo.data_ptr(), index.packed.data_ptr(),
                index.prefix_bases)
        table = ()
        counters = (rows_ptr, chunks_ptr)
    else:
        # the 64-bit scan takes the table's high words after its rows
        scan = kl.lib.sf_mmp_scan64 if wide else kl.lib.sf_mmp_scan
        seed = (index.ht.data_ptr(),
                *((index.ht_hi.data_ptr(),) if wide else ()))
        table = (index.ht_bits, index.ht_probes)
        counters = (rows_ptr,)
    err = scan(
        codes.data_ptr(), pw.data_ptr(), lens.data_ptr(), B2, L,
        index.codes.data_ptr(), index.codes.numel(), index.sa.data_ptr(),
        *seed, index.txp_of_pos.data_ptr(), index.txp_offsets.data_ptr(),
        index.k, C, M, max_steps, *table, int(skip_jump), txp.data_ptr(),
        pos.data_ptr(), vld.data_ptr(), meta.data_ptr(), *counters,
        outs[4].data_ptr() if stamps else None, dev.index, stream,
    )
    kl.check(err, "mmp_scan kernel launch")
    if index.prefix_route:
        mmp_scan_cuda.prefix_launches += 1
    else:
        mmp_scan_cuda.launches += 1
    if stamps:
        mmp_scan_cuda.stamped_launches += 1
    return (txp, pos, vld.view(torch.bool), meta, *outs[4:])


mmp_scan_cuda.launches = 0
mmp_scan_cuda.prefix_launches = 0
mmp_scan_cuda.stamped_launches = 0


def _probe(index: TorchIndex, key0: torch.Tensor, key1: torch.Tensor,
           count: bool = False):
    """Bucketed k-mer table lookup (map/kernels.py seed_hash): up to
    ht_probes buckets from the key's home bucket; a matching entry is a
    find, an empty entry in a probed bucket a miss.  Returns
    (found, lo, cnt, buckets read); the last is a 0-d tensor on the keys'
    device when `count` is set, else None.  `lo` is int64; a 64-bit index
    adds the high word of the matched entry from its side array."""
    mask = (1 << index.ht_bits) - 1
    h = mix_kmer(key0, key1) & mask
    k0 = to_i32(key0)[:, None]
    k1 = to_i32(key1)[:, None]
    n = key0.shape[0]
    found = torch.zeros(n, dtype=torch.bool, device=key0.device)
    done = torch.zeros_like(found)
    lo = torch.zeros(n, dtype=torch.int64, device=key0.device)
    cnt = torch.zeros_like(lo)
    buckets = torch.zeros((), dtype=torch.int64, device=key0.device) \
        if count else None
    for _ in range(index.ht_probes):
        if count:
            buckets += n - done.sum()
        row = index.ht[h]
        cr = row[:, 12:16]
        match = (cr > 0) & (row[:, 0:4] == k0) & (row[:, 4:8] == k1)
        anym = match.any(dim=1)
        j = match.to(torch.uint8).argmax(dim=1, keepdim=True)
        take = ~done & anym
        elo = row[:, 8:12].gather(1, j)[:, 0].long()
        if index.pos_bits == 64:
            elo = (elo & 0xFFFFFFFF) | (
                index.ht_hi[h].gather(1, j)[:, 0].long() << 32)
        lo = torch.where(take, elo, lo)
        cnt = torch.where(take, cr.gather(1, j)[:, 0].long(), cnt)
        found |= take
        done |= anym | (cr == 0).any(dim=1)
        h = torch.where(done, h, (h + 1) & mask)
    return found, lo, cnt, buckets


SEARCH_ITERS = 26  # map/kernels.py `bs_iters`


def clean_counts(codes: torch.Tensor) -> torch.Tensor:
    """(R, L) codes -> (R, L + 1) int32 running count of codes above 3
    (an N or padding): `_clean` reads a window's count from it."""
    bad = (codes >= 4).to(torch.int32)
    return torch.cat([bad.new_zeros((bad.shape[0], 1)),
                      bad.cumsum(1, dtype=torch.int32)], dim=1)


def _clean(cb, lane, p, n):
    """No N in bases [p, p + n) of row lane (the part inside the row),
    per (lane, p) pair: the XLA kernel's `validP` (n = P) and `valid16`
    (n = 16)."""
    L = cb.shape[1] - 1
    return cb[lane, (p + n).clamp(max=L)] == cb[lane, p.clamp(max=L)]


def _search(index, val, lo, hi, depth, upper, reads):
    """map/kernels.py `_search_bound`, per pair: the first m in [lo, hi)
    whose packed[sa[m] + depth] is >= val (> val when `upper`), by
    SEARCH_ITERS halvings at most; reads[1] counts the halvings made."""
    sa, n = index.sa, index.sa.shape[0]
    for _ in range(SEARCH_ITERS):
        cont = lo < hi
        mid = lo + ((hi - lo) >> 1)
        key = u32(index.packed[sa[mid.clamp(0, n - 1)].long() + depth])
        pred = (key <= val) if upper else (key < val)
        lo = torch.where(cont & pred, mid + 1, lo)
        hi = torch.where(cont & ~pred, mid, hi)
        reads[1] += cont.sum()
    return lo


def _refine(index, pw, lane, p, depth, lo, hi, reads):
    """[lo, hi) narrowed to the suffixes whose word at `depth` equals the
    read's: (nhi - nlo, the XLA kernel's emptiness test; min(nlo, nhi);
    nhi)."""
    qa = u32(pw[lane, p + depth])
    nlo = _search(index, qa, lo, hi, depth, False, reads)
    nhi = _search(index, qa, lo, hi, depth, True, reads)
    return nhi - nlo, torch.minimum(nlo, nhi), nhi


def _coarse(index, pw, lane, p):
    """The prefix table's interval of each pair's first P bases."""
    v = u32(pw[lane, p]) >> (2 * (16 - index.prefix_bases))
    return index.table_lo[v].long(), index.table_lo[v + 1].long()


def prefix_seed(index, pw, cb, lens, lane, p, cand_cap, reads):
    """The prefix route's seed at each (lane, p) pair of one index
    (map/kernels.py `seed_prefix`, outside a mesh): (found, lo, cnt),
    int64, found a seed with at least one candidate.  reads[0] counts the
    prefix-table lookups, reads[1] the search steps."""
    pvalid = _clean(cb, lane, p, index.prefix_bases)
    lo, hi = _coarse(index, pw, lane, p)
    reads[0] += pvalid.sum()
    proven = torch.zeros_like(pvalid)
    for w in (0, 1):
        d = 16 * w
        need = (pvalid & ~proven & (hi - lo > cand_cap)
                & (p + d + 16 <= lens[lane]) & _clean(cb, lane, p + d, 16))
        ix = need.nonzero()[:, 0]
        if ix.numel() == 0:
            continue
        diff, nlo, nhi = _refine(index, pw, lane[ix], p[ix], d, lo[ix],
                                 hi[ix], reads)
        empty = diff <= 0
        if index.k >= 16 * (w + 1):
            proven[ix[empty]] = True
        lo[ix[~empty]] = nlo[~empty]
        hi[ix[~empty]] = nhi[~empty]
    cnt = torch.where(pvalid & ~proven, hi - lo, 0)
    return cnt > 0, lo, cnt


def _lcp(codes, lens, text, lane, i, g):
    """True-code LCP of read lane[p] from i against text from g, per
    flat candidate p: N in the read, a separator in the text and the
    read end all stop a match.  Runs in chunks of candidates to bound
    the (chunk, L) temporaries at any read width L."""
    L = codes.shape[1]
    chunk = max(1, (1 << 25) // L)
    j = torch.arange(L, device=codes.device)
    out = []
    for s in range(0, lane.numel(), chunk):
        ln, ii, gg = lane[s:s + chunk], i[s:s + chunk], g[s:s + chunk]
        rpos = ii[:, None] + j[None, :]
        rc = codes[ln[:, None], rpos.clamp(max=L - 1)]
        tc = text[(gg[:, None] + j[None, :]).clamp(max=text.shape[0] - 1)]
        ok = (rpos < lens[ln][:, None]) & (rc < 4) & (rc == tc)
        out.append(ok.to(torch.int32).cumprod(dim=1).sum(dim=1))
    return torch.cat(out) if out else lane.new_zeros(0)


def needed_chunks(lcp: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """Per compared candidate, the 16-byte chunks of the read's remainder
    (`rem` bases from the compare's start) that a compare stopping at the
    first mismatching chunk reads, given the candidate's `lcp`: the chunks
    up to and including the one that holds the first mismatch, all of
    them when the match reaches the read's end."""
    return torch.minimum((rem + 15) // 16, lcp // 16 + 1)


def mmp_scan_reference(lanes: dict, index: TorchIndex, *, cand_cap: int,
                       max_mmps: int, max_steps: int,
                       skip_jump: bool = False, stamps: bool = False,
                       work: dict | None = None):
    """Plain torch version of the scan, vectorized over lanes: each round
    probes one position in every still-active lane, and the candidates of
    the lanes that found a k-mer with cnt <= cand_cap are flattened into
    one list for the LCP.  Same outputs as the kernel (the step stamps
    with `stamps`: a lane's steps are the rounds it was active in, so
    round r is its step r); used by the CPU path and by the on-card
    comparison.

    `work`, when given, receives what these inputs made the scan do:
    on the k-mer route "buckets" (64-byte table rows read), on the prefix
    route "lookups" (prefix-table lookups, two entries each) and
    "search_steps" (binary-search steps, a suffix-array entry and a
    packed word each); on both "candidates" (suffix-array entries read),
    "text_bytes" (text bytes compared, the mismatching one included),
    "stored" (candidates written to a slot, each of which reads
    `txp_of_pos` and `txp_offsets`), "seeds" (probed positions that
    found a seed with cnt <= cand_cap, whose `lo` the scan uses: a 64-bit
    index reads its high word for each on the k-mer route) — the
    data-dependent terms of the kernel's bound — and "chunks"
    (`needed_chunks`: the 16-byte chunks a compare that stops at a
    candidate's first mismatching chunk reads)."""
    _check(lanes, index, cand_cap, max_mmps)
    codes, pw = lanes["codes"], lanes["pw"]
    lens = lanes["lens"].to(torch.int64)
    dev = codes.device
    B2, _ = codes.shape
    C, M, k = cand_cap, max_mmps, index.k
    txp = torch.zeros((B2, M * C), dtype=torch.int32, device=dev)
    pos = torch.zeros((B2, M * C), dtype=torch.int32, device=dev)
    vld = torch.zeros((B2, M * C), dtype=torch.bool, device=dev)
    i = torch.zeros(B2, dtype=torch.int64, device=dev)
    nm = torch.zeros_like(i)
    steps = torch.zeros_like(i)
    over = torch.zeros(B2, dtype=torch.bool, device=dev)
    mlen = torch.zeros_like(i)
    stamp = torch.full((B2, M + 1), -1, dtype=torch.int64, device=dev)
    sa = index.sa.to(torch.int64)
    # the work counters stay on the device until the scan has ended:
    # buckets, candidates, text_bytes, stored, seeds, lookups,
    # search_steps, chunks
    n_work = torch.zeros(8, dtype=torch.int64, device=dev)
    cb = clean_counts(codes) if index.prefix_route else None
    for r in range(max_steps):
        act = ((i + k <= lens) & (nm < M)).nonzero()[:, 0]
        if act.numel() == 0:
            break
        ia = i[act]
        if index.prefix_route:
            found, lo, cnt = prefix_seed(index, pw, cb, lens, act, ia, C,
                                         n_work[5:])
        else:
            key0 = u32(pw[act, ia])
            key1 = u32(pw[act, ia + 16]) >> (2 * (32 - k))
            found, lo, cnt, nb = _probe(index, key0, key1,
                                        work is not None)
            if work is not None:
                n_work[0] += nb
        steps[act] += 1
        if stamps:
            first = act[found & (cnt > C) & ~over[act]]
            stamp[first, M] = r
        over[act] |= found & (cnt > C)
        sel = (found & (cnt <= C)).nonzero()[:, 0]
        adv = torch.ones_like(ia)
        if work is not None:
            n_work[4] += sel.numel()
        if sel.numel():
            ls, is_, cs = act[sel], ia[sel], cnt[sel]
            own = torch.repeat_interleave(
                torch.arange(sel.numel(), device=dev), cs)
            start = torch.cumsum(cs, 0) - cs
            c = torch.arange(own.numel(), device=dev) - start[own]
            g = sa[lo[sel][own] + c]
            lcp = _lcp(codes, lens, index.codes, ls[own], is_[own], g).long()
            if work is not None:
                rem = lens[ls[own]] - is_[own]
                n_work[1] += own.numel()
                n_work[2] += lcp.sum() + (lcp < rem).sum()
                n_work[7] += needed_chunks(lcp, rem).sum()
            lstar = torch.full((sel.numel(),), -1, dtype=torch.int64,
                               device=dev)
            lstar.scatter_reduce_(0, own, lcp, reduce="amax")
            hit = lstar >= k
            hc = hit[own].nonzero()[:, 0]
            if work is not None:
                n_work[3] += hc.numel()
            if hc.numel():
                o = own[hc]
                lane_c = ls[o]
                col = nm[lane_c] * C + c[hc]
                gt = g[hc]
                tx = index.txp_of_pos[gt].long()
                txp[lane_c, col] = tx.to(torch.int32)
                pos[lane_c, col] = (gt - index.txp_offsets[tx].long()
                                    - is_[o]).to(torch.int32)
                vld[lane_c, col] = lcp[hc] == lstar[o]
            hl = ls[hit]
            if stamps:
                stamp[hl, nm[hl]] = r
            mlen[hl] = torch.where(nm[hl] == 0, lstar[hit], mlen[hl])
            nm[hl] += 1
            if skip_jump:
                hadv = lstar + 1
            else:
                hadv = torch.clamp(lstar - k + 1, min=1)
            adv[sel] = torch.where(hit, hadv, 1)
        i[act] = ia + adv
    if work is not None:
        keys = ("buckets", "candidates", "text_bytes", "stored", "seeds",
                "lookups", "search_steps", "chunks")
        got = dict(zip(keys, n_work.tolist()))
        drop = (("buckets",) if index.prefix_route
                else ("lookups", "search_steps"))
        work.update({kk: v for kk, v in got.items() if kk not in drop})
    meta = torch.stack([nm, over.long(), mlen, steps], dim=1)
    out = (txp, pos, vld, meta.to(torch.int32))
    if stamps:
        out += (stamp.to(torch.int32),)
    return out
