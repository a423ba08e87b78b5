"""The MMP scan: per oriented read lane, the bounded maximal-mappable-
prefix search against the k-mer table and suffix array.

Counterpart of sailfish_tpu/map/pallas_kernel.py `mmp_scan_pallas`
(the Pallas `_scan_kernel`) and of the scan loop of map/kernels.py
`map_oriented_lanes`.  `mmp_scan` dispatches on the lanes' device: a
CUDA tensor launches the hand-written kernel (csrc/mmp_scan.cu, through
`mmp_scan_cuda`); a CPU tensor runs `mmp_scan_reference`, the plain
torch version.  A CUDA tensor never reaches the plain version, and a
kernel build or launch failure raises.

Outputs, per lane (B2 lanes, C = cand_cap, M = max_mmps):
  txp, pos  int32 (B2, M*C)  slot m*C + c: candidate c of MMP m — its
                             transcript and in-transcript position minus
                             the query offset i of that MMP
  valid     bool  (B2, M*C)  candidate achieved the MMP length lstar
  meta      int32 (B2, 4)    [n_mmps, overflow, mlen (first MMP's lstar),
                              probed positions]
Slots that hold no candidate (behind an MMP's cnt candidates, and all
slots of MMPs a lane did not find) are zero; the kernel writes them
itself, so its buffers start uninitialised.  Slot order within an MMP
follows the suffix array; the post-pass (map/postpass.py) canonicalizes.
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
    if not (17 <= index.k <= 31):
        raise ValueError(f"the scan needs 17 <= k <= 31 (got {index.k})")
    if cand_cap < 1 or max_mmps < 1:
        raise ValueError("cand_cap and max_mmps must be positive")
    for t in (codes, pw, lens):
        if t.device != index.device:
            raise ValueError(
                f"lanes on {t.device} but the index is on {index.device}")


def mmp_scan(lanes: dict, index: TorchIndex, *, cand_cap: int,
             max_mmps: int, max_steps: int, skip_jump: bool = False):
    """Scan every lane; returns (txp, pos, valid, meta) as documented in
    the module docstring."""
    _check(lanes, index, cand_cap, max_mmps)
    dev = lanes["codes"].device
    kw = dict(cand_cap=cand_cap, max_mmps=max_mmps, max_steps=max_steps,
              skip_jump=skip_jump)
    if dev.type == "cuda":
        return mmp_scan_cuda(lanes, index, **kw)
    if dev.type == "cpu":
        return mmp_scan_reference(lanes, index, **kw)
    raise ValueError(f"unsupported device: {dev}")


def _outputs(B2: int, C: int, M: int, dev, out):
    """The four output tensors of a scan: fresh and uninitialised (the
    kernel writes every slot), or the caller's `out`, checked."""
    shapes = (((B2, M * C), torch.int32), ((B2, M * C), torch.int32),
              ((B2, M * C), torch.uint8), ((B2, 4), torch.int32))
    if out is None:
        return tuple(torch.empty(s, dtype=d, device=dev) for s, d in shapes)
    if len(out) != 4:
        raise ValueError("out needs four tensors: txp, pos, valid, meta")
    for o, (s, d) in zip(out, shapes):
        if o.shape != s or o.dtype != d or o.device != dev \
                or not o.is_contiguous() or o.data_ptr() % 16:
            raise ValueError(
                f"out tensor {tuple(o.shape)} {o.dtype} on {o.device}: need "
                f"{s} {d} on {dev}, contiguous and 16-byte aligned")
    return tuple(out)


def mmp_scan_cuda(lanes: dict, index: TorchIndex, *, cand_cap: int,
                  max_mmps: int, max_steps: int, skip_jump: bool = False,
                  out=None, rows_read: torch.Tensor | None = None):
    """Launch csrc/mmp_scan.cu on the current stream of the lanes' CUDA
    device.  `mmp_scan_cuda.launches` counts successful launches.

    `out`, when given, is four preallocated tensors (int32 txp and pos,
    uint8 valid, int32 meta) that the kernel fills instead of fresh ones;
    whatever they held is overwritten, every slot.  `rows_read`, when
    given, is a one-element int64 tensor on the device to which the kernel
    adds the 64-byte table rows it reads (a measurement aid: it costs an
    atomic per probe window)."""
    from .. import _ext

    _check(lanes, index, cand_cap, max_mmps)
    dev = lanes["codes"].device
    if dev.type != "cuda":
        raise ValueError(f"mmp_scan_cuda needs CUDA tensors (got {dev})")
    B2, L = lanes["codes"].shape
    if L % 8:
        raise ValueError(f"the kernel needs a read width that is a multiple "
                         f"of 8 (got {L})")
    if rows_read is not None and (
            rows_read.dtype != torch.int64 or rows_read.numel() != 1
            or rows_read.device != dev):
        raise ValueError("rows_read must be one int64 on the lanes' device")
    # the kernel copies lane rows with 16-byte loads
    codes, pw, lens = (
        t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
            memory_format=torch.contiguous_format)
        for t in (lanes["codes"], lanes["pw"], lanes["lens"]))
    kl = _ext.load()
    C, M = cand_cap, max_mmps
    txp, pos, vld, meta = _outputs(B2, C, M, dev, out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kl.lib.sf_mmp_scan(
        codes.data_ptr(), pw.data_ptr(), lens.data_ptr(), B2, L,
        index.codes.data_ptr(), index.codes.numel(), index.sa.data_ptr(),
        index.ht.data_ptr(), index.txp_of_pos.data_ptr(),
        index.txp_offsets.data_ptr(), index.k, C, M, max_steps,
        index.ht_bits, index.ht_probes, int(skip_jump), txp.data_ptr(),
        pos.data_ptr(), vld.data_ptr(), meta.data_ptr(),
        None if rows_read is None else rows_read.data_ptr(), dev.index,
        stream,
    )
    kl.check(err, "mmp_scan kernel launch")
    mmp_scan_cuda.launches += 1
    return txp, pos, vld.view(torch.bool), meta


mmp_scan_cuda.launches = 0


def _probe(index: TorchIndex, key0: torch.Tensor, key1: torch.Tensor,
           count: bool = False):
    """Bucketed k-mer table lookup (map/kernels.py seed_hash): up to
    ht_probes buckets from the key's home bucket; a matching entry is a
    find, an empty entry in a probed bucket a miss.  Returns
    (found, lo, cnt, buckets read); the last is a 0-d tensor on the keys'
    device when `count` is set, else None."""
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
        lo = torch.where(take, row[:, 8:12].gather(1, j)[:, 0].long(), lo)
        cnt = torch.where(take, cr.gather(1, j)[:, 0].long(), cnt)
        found |= take
        done |= anym | (cr == 0).any(dim=1)
        h = torch.where(done, h, (h + 1) & mask)
    return found, lo, cnt, buckets


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


def mmp_scan_reference(lanes: dict, index: TorchIndex, *, cand_cap: int,
                       max_mmps: int, max_steps: int,
                       skip_jump: bool = False, work: dict | None = None):
    """Plain torch version of the scan, vectorized over lanes: each round
    probes one position in every still-active lane, and the candidates of
    the lanes that found a k-mer with cnt <= cand_cap are flattened into
    one list for the LCP.  Same outputs as the kernel; used by the CPU
    path and by the on-card comparison.

    `work`, when given, receives what these inputs made the scan do:
    "buckets" (64-byte table rows read), "candidates" (suffix-array
    entries read), "text_bytes" (text bytes compared, the mismatching
    one included) and "stored" (candidates written to a slot, each of
    which reads `txp_of_pos` and `txp_offsets`) — the data-dependent
    terms of the kernel's bound."""
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
    sa = index.sa.to(torch.int64)
    # the work counters stay on the device until the scan has ended
    n_work = torch.zeros(4, dtype=torch.int64, device=dev)
    for _ in range(max_steps):
        act = ((i + k <= lens) & (nm < M)).nonzero()[:, 0]
        if act.numel() == 0:
            break
        ia = i[act]
        key0 = u32(pw[act, ia])
        key1 = u32(pw[act, ia + 16]) >> (2 * (32 - k))
        found, lo, cnt, nb = _probe(index, key0, key1, work is not None)
        if work is not None:
            n_work[0] += nb
        steps[act] += 1
        over[act] |= found & (cnt > C)
        sel = (found & (cnt <= C)).nonzero()[:, 0]
        adv = torch.ones_like(ia)
        if sel.numel():
            ls, is_, cs = act[sel], ia[sel], cnt[sel]
            own = torch.repeat_interleave(
                torch.arange(sel.numel(), device=dev), cs)
            start = torch.cumsum(cs, 0) - cs
            c = torch.arange(own.numel(), device=dev) - start[own]
            g = sa[lo[sel][own] + c]
            lcp = _lcp(codes, lens, index.codes, ls[own], is_[own], g).long()
            if work is not None:
                at_end = is_[own] + lcp >= lens[ls[own]]
                n_work[1] += own.numel()
                n_work[2] += lcp.sum() + (~at_end).sum()
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
            mlen[hl] = torch.where(nm[hl] == 0, lstar[hit], mlen[hl])
            nm[hl] += 1
            if skip_jump:
                hadv = lstar + 1
            else:
                hadv = torch.clamp(lstar - k + 1, min=1)
            adv[sel] = torch.where(hit, hadv, 1)
        i[act] = ia + adv
    if work is not None:
        work.update(zip(("buckets", "candidates", "text_bytes", "stored"),
                        n_work.tolist()))
    meta = torch.stack([nm, over.long(), mlen, steps], dim=1)
    return txp, pos, vld, meta.to(torch.int32)
