"""Sequence-specific and fragment-GC bias modelling.

Counterpart of sailfish_tpu/stats/bias.py, same semantics:
  * ReadKmerDist<6>::update — observed read-start 6-mer contexts
    (reference include/ReadKmerDist.hpp:33-73): for a fwd hit the RC
    6-mer starting 2 bases before the read start; for an rc hit the FWD
    6-mer starting 4 bases before the (right-side) start; pseudocount 1
    per bin; one successful sample per fragment, global budget
    --numBiasSamples (src/SailfishQuantify.cpp:270-287)
  * observed fragment GC histogram — for every paired joint hit with
    0 < start and start+fragLen < RefLength, bin lrint(100 * gc /
    (len+1)) where gc counts positions (start, start+fragLen]
    (Transcript::gcFrac, include/Transcript.hpp:85-95;
    src/SailfishQuantify.cpp:372-389)
  * sailfish::utils::updateEffectiveLengths — expected k-mer / GC
    distributions from current abundances and the FLD, per-position
    factors, bias-corrected effective lengths
    (src/SailfishUtils.cpp:611-926)

Where the work runs.  `BiasState` is host state; its per-hit replay
(`observe_fragment`) is the oracle `--backend refimpl` uses.  The device
backend observes with `bias_observe`, torch ops over the joint-hit slots
of a batch.  `update_effective_lengths` runs on the device that holds the
bias text (`make_bias_text`), in float64, over the positions of the
active transcripts only and in chunks of whole transcripts, so its
memory is bounded by `chunk_positions` whatever the transcriptome's
size.  Within a chunk every sum is a `bincount` with weights (atomics on
CUDA: the last bits differ from the CPU's).

Two choices that differ from the JAX package's device path:
  * a 6-mer window that holds a transcript N gives no sample, as in the
    host oracle and the C++ reference (`kmer_index < 0`).  The JAX device
    path reads 2-bit packed text, where an N is an A, and counts it.
  * the unsampled GC percentage is rounded in integer arithmetic (half
    to even), exact at any fragment length; it equals the oracle's
    float64 `rint` and the JAX device path's float32 one wherever those
    are exact.  The sampled path (--gcSizeSamp > 1) interpolates in
    float64 on the device as on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import dna
from ..config import QuantOpts
from ..device import as_device, synchronize
from ..index.device import TEXT_PAD
from ..libformat import MateStatus
from ..map.pair import PAIRED, RIGHT

K_BIAS = 6          # ReadKmerDist<6>
NUM_KMER_BINS = 4 ** K_BIAS
TRUNC = K_BIAS      # reference `trunc = K` (:696)
MIN_ALPHA = 1e-8
CHUNK_POSITIONS = 1 << 24
_I64_MAX = 2**63 - 1


def _is_gc(codes: torch.Tensor) -> torch.Tensor:
    return (codes == dna.G) | (codes == dna.C)


def make_bias_text(index, device, opts: QuantOpts, tindex=None) -> dict:
    """The transcriptome as the bias model reads it, on `device`: the
    true text codes (an N is code 4) with TEXT_PAD trailing bytes,
    transcript offsets and lengths, and for GC observation the
    exclusive GC prefix int32[N+1] or, with --gcSizeSamp > 1, the
    sampled tables of `build_sampled_gc`.  A `tindex` (TorchIndex) on
    the same device lends its tensors, so the text is not uploaded a
    second time."""
    dev = as_device(device)
    if tindex is not None and tindex.device == dev:
        codes, offs, lens = tindex.codes, tindex.txp_offsets, tindex.txp_lens
    else:
        codes = torch.from_numpy(np.concatenate(
            [index.codes, np.full(TEXT_PAD, dna.SEP, np.uint8)])).to(dev)
        offs = torch.from_numpy(
            np.ascontiguousarray(index.txp_offsets, np.int32)).to(dev)
        lens = torch.from_numpy(
            np.ascontiguousarray(index.txp_lens, np.int32)).to(dev)
    n = len(index.codes)
    text = {
        "codes": codes, "n_text": n, "txp_offsets": offs, "txp_lens": lens,
        "ref_lens": index.txp_lens.astype(np.int64),
        "offsets": index.txp_offsets.astype(np.int64),
    }
    if opts.gc_bias_correct:
        if opts.gc_samp_factor > 1:
            text["sgc"] = build_sampled_gc(codes[:n], offs, lens,
                                           opts.gc_samp_factor)
        else:
            excl = torch.zeros(n + 1, dtype=torch.int32, device=dev)
            torch.cumsum(_is_gc(codes[:n]), 0, dtype=torch.int32,
                         out=excl[1:])
            text["gc_excl"] = excl
    return text


def build_sampled_gc(codes: torch.Tensor, txp_offsets: torch.Tensor,
                     txp_lens: torch.Tensor, step: int) -> dict:
    """Sampled per-transcript inclusive GC prefixes — the --gcSizeSamp
    memory/speed trade (reference Transcript::computeGCContentSampled_,
    include/Transcript.hpp:156-181): every `step`-th inclusive count is
    stored, plus a final sample at RefLength-1 when the last regular
    sample falls short of it.  `codes` is the text without padding.

    Returns tensors on `codes`' device:
      sc[S]           float64 sampled inclusive counts, all txps packed
      samp_off[T]     int64 first sample index of each transcript
      n_samp[T]       int64 samples per transcript
      gc_frac_len[T]  float64 (RefLength-1)/step
      last_regular[T] int64 ceil(gc_frac_len)
    """
    dev = codes.device
    L = txp_lens.to(torch.int64)
    T = L.shape[0]
    offsets = txp_offsets.to(torch.int64)
    # exclusive global prefix, one past the end included
    excl = torch.zeros(codes.shape[0] + 1, dtype=torch.int64, device=dev)
    torch.cumsum(_is_gc(codes), 0, out=excl[1:])

    n_reg = (L + step - 1) // step
    extra = (((n_reg - 1) * step) < (L - 1)).to(torch.int64)
    n_samp = n_reg + extra
    samp_off = torch.cumsum(n_samp, 0) - n_samp
    tot = int(n_samp.sum())

    t_of = torch.repeat_interleave(torch.arange(T, device=dev), n_samp)
    j_of = torch.arange(tot, device=dev) - samp_off[t_of]
    is_final = (extra[t_of] == 1) & (j_of == n_samp[t_of] - 1)
    local = torch.where(is_final, L[t_of] - 1, j_of * step)
    gpos = offsets[t_of] + local
    # per-transcript inclusive count at `local`
    sc = (excl[gpos + 1] - excl[offsets[t_of]]).to(torch.float64)
    gc_frac_len = (L - 1).to(torch.float64) / step
    return {
        "step": step,
        "sc": sc,
        "samp_off": samp_off,
        "n_samp": n_samp,
        "gc_frac_len": gc_frac_len,
        "last_regular": torch.ceil(gc_frac_len).to(torch.int64),
    }


def gc_count_interp(sgc: dict, t, p, ref_len):
    """Transcript::gcCountInterp_ (include/Transcript.hpp:124-155),
    including its reversed-lerp quirk: the weight `lambda` (the fraction
    of the way toward the next sample) multiplies the previous sample's
    count, so values interpolate backwards between samples.  Kept on
    purpose: parity with the reference.  t, p and ref_len are int64
    tensors of one shape."""
    sc = sgc["sc"]
    off = sgc["samp_off"][t]
    n = sgc["n_samp"][t]
    last_reg = sgc["last_regular"][t]
    frac_len = sgc["gc_frac_len"][t]
    hi = sc.shape[0] - 1

    frac_p = p.to(sc.dtype) / sgc["step"]
    samp_ind = torch.floor(frac_p)
    use_last = samp_ind >= last_reg.to(sc.dtype)
    next_ind = torch.where(use_last, n - 1, samp_ind.to(torch.int64) + 1)
    frac_next = torch.where(use_last, frac_len, next_ind.to(sc.dtype))
    denom = frac_next - samp_ind
    lam = (frac_p - samp_ind) / torch.where(denom != 0, denom, 1.0)
    si = (off + samp_ind.to(torch.int64)).clamp(0, hi)
    ni = (off + next_ind).clamp(0, hi)
    v = lam * sc[si] + (1.0 - lam) * sc[ni]
    # p == RefLength-1: the final sample's value, no interpolation
    return torch.where(p == ref_len - 1, sc[(off + n - 1).clamp(0, hi)], v)


def gc_frac_sampled(sgc: dict, t, s, e, ref_len):
    """Transcript::gcFrac for the sampled path (gcStep_ > 1,
    include/Transcript.hpp:85-95): interpolated counts at both closed
    endpoints, lrint rounding (`torch.round` rounds half to even)."""
    gc = (gc_count_interp(sgc, t, e, ref_len)
          - gc_count_interp(sgc, t, s, ref_len))
    return torch.round(100.0 * gc / (e - s + 1).to(gc.dtype))


def round_percent(gc: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """rint(100 * gc / length) for integer tensors, half to even, in
    integer arithmetic."""
    den = 2 * length
    num = 200 * gc + length
    q = torch.div(num, den, rounding_mode="floor")
    tie = (num - q * den == 0) & (q % 2 == 1)
    return q - tie.to(q.dtype)


class BiasState:
    """Observation-side state (the ReadExperiment bias fields), on the
    host.  `index` arguments are host QuasiIndex objects."""

    def __init__(self, opts: QuantOpts):
        self.opts = opts
        self.read_bias_counts = np.ones(NUM_KMER_BINS, dtype=np.int64)
        self.observed_gc = np.zeros(101, dtype=np.int64)
        self.remaining_bias_samples = opts.num_bias_samples
        self.expected_seq_bias = np.ones(NUM_KMER_BINS, dtype=np.float64)
        self.expected_gc = np.ones(101, dtype=np.float64)
        # paired slots the device counted as GC observations (the device
        # backend's own count, beside the histogram's sum)
        self.gc_slots = 0
        self._gc_prefix_cache: dict[int, np.ndarray] = {}
        self._sgc = None  # sampled-GC tables (gc_samp_factor > 1)

    # ---------- helpers ----------

    def _txp_seq(self, index, t: int) -> np.ndarray:
        o = int(index.txp_offsets[t])
        return index.codes[o:o + int(index.txp_lens[t])]

    def _gc_inclusive_prefix(self, index, t: int) -> np.ndarray:
        """GCCount_[i] = # G/C in [0, i] (inclusive), per transcript."""
        cached = self._gc_prefix_cache.get(t)
        if cached is None:
            seq = self._txp_seq(index, t)
            cached = np.cumsum((seq == dna.G) | (seq == dna.C))
            self._gc_prefix_cache[t] = cached
        return cached

    def _sampled_gc(self, index) -> dict:
        if self._sgc is None:
            self._sgc = build_sampled_gc(
                torch.from_numpy(index.codes),
                torch.from_numpy(index.txp_offsets.astype(np.int64)),
                torch.from_numpy(index.txp_lens.astype(np.int64)),
                self.opts.gc_samp_factor)
        return self._sgc

    def gc_frac(self, index, t: int, s: int, e: int) -> int:
        if self.opts.gc_samp_factor > 1:
            fr = gc_frac_sampled(
                self._sampled_gc(index), *(torch.tensor([x]) for x in (
                    t, s, e, int(index.txp_lens[t]))))
            return int(fr.clamp(0, 100))
        gcc = self._gc_inclusive_prefix(index, t)
        gc = int(gcc[e]) - int(gcc[s])
        return int(np.rint(100.0 * gc / (e - s + 1)))

    # ---------- observation (refimpl / oracle path) ----------

    def observe_fragment(self, index, rm, len1: int) -> None:
        """Observe one mapped fragment's joint hits, the per-hit loop at
        src/SailfishQuantify.cpp:260-393."""
        opts = self.opts
        need_seq = opts.bias_correct and self.remaining_bias_samples > 0
        for h in rm.joint:
            t = h.txp
            ref_len = int(index.txp_lens[t])
            read_len = h.read_len or len1
            if need_seq:
                start_pos = h.pos if h.fwd else h.pos + read_len
                if 0 < start_pos < ref_len:
                    if self._read_bias_update(index, t, start_pos, h.fwd):
                        self.remaining_bias_samples -= 1
                        need_seq = False
            if (opts.gc_bias_correct
                    and h.mate_status == MateStatus.PAIRED_END_PAIRED):
                start = min(h.pos, h.mate_pos)
                stop = start + h.frag_len
                if start > 0 and stop < ref_len:
                    self.observed_gc[self.gc_frac(index, t, start, stop)] += 1

    def _read_bias_update(self, index, t: int, p: int, fwd: bool) -> bool:
        """ReadKmerDist::update (include/ReadKmerDist.hpp:33-73)."""
        seq = self._txp_seq(index, t)
        end = len(seq)
        back = 2 if fwd else 4
        # the window [p-back, p-back+6) must fit inside the transcript
        if p < back or (p - back + K_BIAS) >= end:
            return False
        w = seq[p - back:p - back + K_BIAS]
        idx = (dna.kmer_index_rc if fwd else dna.kmer_index)(w, K_BIAS)
        if idx < 0:
            return False
        self.read_bias_counts[idx] += 1
        return True

    def observe_batch(self, index, b1, bs) -> None:
        """Fold one batch: `bs` is the BatchStats of `finish_batch_fast`.
        The refimpl backend hands over its ReadMappings (`per_read`) and
        the per-hit loop replays them; the device backend hands over its
        per-fragment 6-mer samples and the GC histogram.  `b1` is the
        batch of first mates (or of the single-end reads)."""
        if bs.per_read is not None:
            for i, rm in enumerate(bs.per_read):
                if rm.joint:  # the reference observes every joint hit
                    self.observe_fragment(index, rm, int(b1.lens[i]))
            return
        if bs.gc_hist_fn is not None:
            self.observed_gc += bs.gc_hist_fn().astype(np.int64)
            self.gc_slots += int(bs.gc_slots)
        if bs.seq_samples_fn is not None and self.opts.bias_correct \
                and self.remaining_bias_samples > 0:
            # file order; the global --numBiasSamples budget gates here
            samples = bs.seq_samples_fn()
            take = samples[samples >= 0][:self.remaining_bias_samples]
            if len(take):
                self.read_bias_counts += np.bincount(
                    take, minlength=NUM_KMER_BINS)
                self.remaining_bias_samples -= len(take)


def _kmers6(codes: torch.Tensor, g: torch.Tensor):
    """(fwd index, rc index, has-N) of the 6-mer window starting at each
    text position of `g` (int64)."""
    fwd6 = torch.zeros_like(g)
    rc6 = torch.zeros_like(g)
    bad = torch.zeros_like(g, dtype=torch.bool)
    for j in range(K_BIAS):
        c = codes[g + j].to(torch.int64)
        bad |= c >= 4
        c = c & 3
        fwd6 |= c << (2 * (K_BIAS - 1 - j))
        rc6 |= (3 - c) << (2 * j)
    return fwd6, rc6, bad


def bias_observe(slots: dict, text: dict, lens1, lens2, *, gc_on: bool,
                 seq_on: bool):
    """Bias observation over the joint-hit slots of one batch
    (map/pair.py `merge_and_collapse(return_slots=True)`), the per-hit
    loop of src/SailfishQuantify.cpp:260-393:
      * seq bias: the first joint hit, in (txp, slot) order, whose
        context window fits and holds no N gives the fragment's one
        6-mer sample (the budget is applied on the host)
      * GC: every valid paired slot with 0 < start and stop < RefLength
        gives one observation

    Returns (seq_sample (B,) int32 with -1 = none, gc_hist (101,) int64,
    gc_slots 0-dim int64: the slots that qualified for the histogram)."""
    txp = slots["txp"]
    pos = slots["pos"].to(torch.int64)
    fwd = slots["fwd"]
    status = slots["status"]
    valid = slots["valid"]
    B, W = txp.shape
    dev = txp.device

    # invalid slots carry the sort's sentinel, not a transcript
    tsafe = torch.where(valid, txp, 0).to(torch.int64)
    read_len = torch.where(status == RIGHT, lens2[:, None],
                           lens1[:, None]).to(torch.int64)
    ref_len = text["txp_lens"][tsafe].to(torch.int64)
    off = text["txp_offsets"][tsafe].to(torch.int64)

    seq_sample = torch.full((B,), -1, dtype=torch.int32, device=dev)
    if seq_on:
        start_pos = torch.where(fwd, pos, pos + read_len)
        in_ref = (start_pos > 0) & (start_pos < ref_len)
        # fwd hit: RC 6-mer at start-2; rc hit: FWD 6-mer at start-4
        w_off = torch.where(fwd, 2, 4)
        fits = (start_pos >= w_off) & (start_pos - w_off + K_BIAS < ref_len)
        g = (off + start_pos - w_off).clamp(0, text["n_text"] - 1)
        fwd6, rc6, has_n = _kmers6(text["codes"], g)
        ok = valid & in_ref & fits & ~has_n
        kidx = torch.where(fwd, rc6, fwd6)
        # first qualifying hit in merged jointHits order = ascending
        # (txp, slot): slots are block-ordered (left before right), not
        # txp-sorted, so order by an explicit int64 key
        okey = torch.where(
            ok, tsafe * W + torch.arange(W, device=dev)[None, :], _I64_MAX)
        first = okey.argmin(dim=1, keepdim=True)
        seq_sample = torch.where(ok.any(dim=1), kidx.gather(1, first)[:, 0],
                                 -1).to(torch.int32)

    gc_hist = torch.zeros(101, dtype=torch.int64, device=dev)
    gc_slots = torch.zeros((), dtype=torch.int64, device=dev)
    if gc_on:
        start = torch.minimum(pos, slots["mpos"].to(torch.int64))
        stop = start + slots["frag_len"].to(torch.int64)
        ok = valid & (status == PAIRED) & (start > 0) & (stop < ref_len)
        length = (stop - start + 1).clamp(min=1)
        if "sgc" in text:
            st = torch.where(ok, tsafe, 0)
            sgc = text["sgc"]
            gc = (gc_count_interp(sgc, st, stop, ref_len)
                  - gc_count_interp(sgc, st, start, ref_len))
            frac = torch.round(100.0 * gc / length.to(gc.dtype)).to(
                torch.int64)
        else:
            excl = text["gc_excl"]
            n = text["n_text"]
            gc = (excl[(off + stop + 1).clamp(0, n)]
                  - excl[(off + start + 1).clamp(0, n)]).to(torch.int64)
            frac = round_percent(gc, length)
        frac = frac.clamp(0, 100)
        gc_hist = torch.bincount(torch.where(ok, frac, 101).reshape(-1),
                                 minlength=102)[:101]
        gc_slots = ok.sum()
    return seq_sample, gc_hist, gc_slots


class _Chunk:
    """The positions of some whole transcripts, on the device: for each
    position its transcript (chunk-local), its offset within it, the
    transcript's length and its place in the text."""

    def __init__(self, text: dict, ids: np.ndarray):
        dev = text["codes"].device
        lens = torch.from_numpy(text["ref_lens"][ids]).to(dev)
        offs = torch.from_numpy(text["offsets"][ids]).to(dev)
        self.ids_host = ids
        self.ids = torch.from_numpy(ids).to(dev)
        self.n = len(ids)
        self.max_len = int(text["ref_lens"][ids].max())
        self.tid = torch.repeat_interleave(
            torch.arange(self.n, device=dev), lens)
        self.size = self.tid.shape[0]
        starts = torch.cumsum(lens, 0) - lens
        self.local_i = torch.arange(self.size, device=dev) - starts[self.tid]
        self.rl = lens[self.tid]
        self.g = offs[self.tid] + self.local_i

    def per_txp(self, values: np.ndarray) -> torch.Tensor:
        """A per-transcript float64 vector of the chunk's transcripts,
        spread over their positions."""
        v = torch.from_numpy(np.ascontiguousarray(values, np.float64))
        return v.to(self.tid.device)[self.tid]


def _chunks(text: dict, ids: np.ndarray, chunk_positions: int):
    """`ids` cut into runs of whole transcripts of at most
    `chunk_positions` positions (one transcript at least)."""
    csum = np.cumsum(text["ref_lens"][ids])
    start = 0
    while start < len(ids):
        base = int(csum[start - 1]) if start else 0
        end = int(np.searchsorted(csum, base + chunk_positions, "right"))
        end = max(end, start + 1)
        yield _Chunk(text, ids[start:end])
        start = end


def update_effective_lengths(
    opts: QuantOpts,
    text: dict,
    bias: BiasState,
    fld_pdf_cdf,            # (pdf, cdf) float64 arrays over fragment length
    eff_lens_in: np.ndarray,
    alphas: np.ndarray,
    num_fwd: int,
    num_rc: int,
    *,
    chunk_positions: int = CHUNK_POSITIONS,
) -> np.ndarray:
    """sailfish::utils::updateEffectiveLengths
    (src/SailfishUtils.cpp:611-926) on the device of `text`
    (`make_bias_text`), float64.  Transcripts that are not active
    (alpha < 1e-8, or nothing left unprocessed) take no part in either
    pass, so only the positions of active transcripts are visited."""
    _, cdf = fld_pdf_cdf
    num_mappings = num_fwd + num_rc
    if num_mappings == 0:
        return eff_lens_in
    if opts.gc_bias_correct == opts.bias_correct:
        # neither model, or both: the reference refuses the combination
        # (:636-641)
        return eff_lens_in
    prob_fwd = num_fwd / num_mappings
    prob_rc = num_rc / num_mappings

    dev = text["codes"].device
    codes = text["codes"]
    ref_lens = text["ref_lens"]
    T = len(ref_lens)
    f64 = torch.float64

    eff_in = np.asarray(eff_lens_in, dtype=np.float64)
    alphas = np.asarray(alphas, dtype=np.float64)
    unprocessed = np.maximum(0, ref_lens - eff_in.astype(np.int64))
    active = (alphas >= MIN_ALPHA) & (unprocessed > 0)
    contribution = np.where(active, alphas / eff_in, 0.0)
    ids = np.nonzero(active)[0]

    cdf = np.asarray(cdf, dtype=np.float64)
    cdf_t = torch.from_numpy(cdf).to(dev)
    ncdf = len(cdf)

    def cdf_at(x):
        return torch.where(x < ncdf, cdf_t[x.clamp(0, ncdf - 1)],
                           1.0) * (x >= 0)

    def cdf_host(x: int) -> float:
        return (float(cdf[x]) if x < ncdf else 1.0) * (x >= 0)

    def hist(idx, w, mask, bins):
        return torch.bincount(torch.where(mask, idx, 0),
                              weights=torch.where(mask, w, 0.0),
                              minlength=bins)

    fld_low, fld_high = 0, 1
    gc_samp = max(1, opts.pdf_samp_factor)
    if opts.gc_bias_correct:
        # fldLow/fldHigh: cdf crossing 0.005 / 0.995 (:672-684)
        fld_low = int(np.argmax(cdf >= 0.005)) if (cdf >= 0.005).any() else 0
        fld_high = int(np.argmax(cdf >= 0.995)) if (cdf >= 0.995).any() else 1
    sgc = None
    if opts.gc_bias_correct and opts.gc_samp_factor > 1:
        # every gcFrac call uses the sampled tables, observation and
        # expectation alike (include/Transcript.hpp:85-95)
        sgc = text.get("sgc") or build_sampled_gc(
            codes[:text["n_text"]], text["txp_offsets"], text["txp_lens"],
            opts.gc_samp_factor)

    def gc_pass(ch: _Chunk, m_pos, weigh):
        """The loop over fragment lengths of one chunk: `weigh(fl, ok,
        fr, mass)` takes, for the positions `ok` where a fragment of
        length fl fits, its GC percentage `fr` and the FLD mass of
        (previous fl, fl].  A position that fits fl fitted every shorter
        length, so the mass it saw last is the previous fl's."""
        if sgc is None:
            cum = torch.cumsum(_is_gc(codes[ch.g]), 0)
            j = torch.arange(ch.size, device=dev)
        prev = cdf_host(0)
        for fl in range(fld_low, fld_high + 1, gc_samp):
            if fl - 1 >= ch.max_len:
                break  # no transcript of the chunk holds such a fragment
            ok = m_pos & (ch.local_i + fl - 1 < ch.rl)
            if sgc is None:
                gc = cum[(j + fl - 1).clamp(0, ch.size - 1)] - cum
                fr = round_percent(gc, torch.full_like(gc, max(fl, 1)))
            else:
                fr = gc_frac_sampled(sgc, ch.ids[ch.tid], ch.local_i,
                                     ch.local_i + fl - 1, ch.rl)
                fr = torch.where(ok, fr, 0.0).to(torch.int64)
            weigh(ok, fr.clamp(0, 100), cdf_host(fl) - prev)
            prev = cdf_host(fl)

    # ---- pass A: expected distributions (:728-784) ----
    expected_seq = torch.ones(NUM_KMER_BINS, dtype=f64, device=dev)
    expected_gc = torch.ones(101, dtype=f64, device=dev)
    for ch in _chunks(text, ids, chunk_positions):
        contrib = ch.per_txp(contribution[ch.ids_host])
        in_body = ch.local_i <= ch.rl - TRUNC - 1
        if opts.bias_correct:
            fwd6, rc6, has_n = _kmers6(codes, ch.g)
            m = in_body & ~has_n & (contrib > 0)
            # fwd direction: RC 6-mer of the window at i, fragStartPos =
            # i + 2, maxFragLen = refLen - fragStartPos + 1
            max_fl = ch.rl - (ch.local_i + 2) + 1
            expected_seq += hist(
                rc6, prob_fwd * contrib * cdf_at(max_fl),
                m & (max_fl >= 0) & (max_fl < ch.rl), NUM_KMER_BINS)
            # rc direction: FWD 6-mer at i, fragStartPos = i + 4,
            # maxFragLen = fragStartPos + 1
            max_fl = ch.local_i + 5
            expected_seq += hist(
                fwd6, prob_rc * contrib * cdf_at(max_fl),
                m & (max_fl < ch.rl), NUM_KMER_BINS)
        else:
            def weigh(ok, fr, mass, contrib=contrib):
                expected_gc.add_(hist(fr, contrib * mass, ok, 101))

            gc_pass(ch, in_body & (contrib > 0), weigh)
    expected_seq = expected_seq.cpu().numpy()
    expected_gc = expected_gc.cpu().numpy()

    # ---- priors and normalization (:789-804) ----
    read_norm = float(bias.read_bias_counts.sum())
    txome_norm = float(expected_seq.sum())
    gc_read_norm = float(bias.observed_gc.sum())
    gc_txome_norm = float(expected_gc.sum())
    if opts.bias_correct:
        pmass = float(NUM_KMER_BINS)
        # guard the no-observations case (read_norm == pmass from the
        # pseudocounts alone; the reference would divide by zero)
        prior = ((pmass / max(read_norm - pmass, 1.0)) * txome_norm) / pmass
        ratio = torch.from_numpy(
            bias.read_bias_counts / (expected_seq + prior)).to(dev)
        norm = txome_norm / read_norm
    else:
        pmass = 101.0
        prior = ((pmass / max(gc_read_norm - pmass, 1.0))
                 * gc_txome_norm) / 101.0
        ratio = torch.from_numpy(
            bias.observed_gc / (prior + expected_gc)).to(dev)
        norm = gc_txome_norm / gc_read_norm

    # ---- pass B: per-position factors -> effective lengths (:806-924) ----
    eff = np.zeros(T, dtype=np.float64)
    for ch in _chunks(text, ids, chunk_positions):
        in_body = ch.local_i <= ch.rl - TRUNC - 1
        if opts.bias_correct:
            fwd6, rc6, has_n = _kmers6(codes, ch.g)
            m = in_body & ~has_n
            # fwd: contributes at fragStartPos = i+2; rc: at i+4
            factor = torch.where(
                m & (ch.local_i + 2 < ch.rl),
                prob_fwd * ratio[rc6] * cdf_at(ch.rl - (ch.local_i + 2) + 1),
                0.0)
            factor += torch.where(
                m & (ch.local_i + 4 < ch.rl),
                prob_rc * ratio[fwd6] * cdf_at(ch.local_i + 5), 0.0)
        else:
            factor = torch.zeros(ch.size, dtype=f64, device=dev)

            def weigh(ok, fr, mass, factor=factor):
                sp = ratio[fr] * mass
                # the fragment's two ends lie in one transcript
                factor.add_(torch.where(ok, sp * prob_fwd + sp * prob_rc,
                                        0.0))

            gc_pass(ch, in_body, weigh)
        eff[ch.ids_host] = torch.bincount(
            ch.tid, weights=factor, minlength=ch.n).cpu().numpy()
    eff *= norm

    eff_out = eff_in.copy()
    accept = active & (eff > unprocessed)
    eff_out[accept] = eff[accept]
    bias.expected_seq_bias = expected_seq
    bias.expected_gc = expected_gc
    return eff_out


def run_em_with_bias(eq, eff_lens, text: dict, bias: BiasState, state,
                     opts: QuantOpts, *, device):
    """EM with effective-length recomputation at iterations 50/500/1000
    (src/CollapsedEMOptimizer.cpp:814-840), run as host-controlled
    segments of `infer/em.py run_em`.  The recompute happens exactly
    when the reference's loop would reach those iterations unconverged;
    class weights refresh from the new effective lengths
    (updateEqClassWeights, :527-555) on the next segment.  Returns
    (EMResult over all segments, effective lengths, seconds of each
    `update_effective_lengths` call)."""
    from ..infer.em import run_em
    from .fld import EmpiricalDistribution

    fld_hist = state.fl_hist
    emp = EmpiricalDistribution(np.arange(len(fld_hist), dtype=np.int64),
                                fld_hist.astype(np.int64))
    pdf_cdf = (emp.pdfvals, emp.cdfvals)
    dev = as_device(device)

    eff = np.asarray(eff_lens, dtype=np.float64)
    alphas = None  # the first segment starts from the uniform active init
    segments = [(50, 50), (0, 450), (0, 500), (0, opts.em_max_iter - 1000)]
    total_iters = 0
    update_seconds = []
    for si, (min_it, max_it) in enumerate(segments):
        em = run_em(eq, eff, float(state.num_mapped), len(eff), device=dev,
                    use_vbem=opts.use_vb_opt, rel_diff_tol=opts.em_tolerance,
                    min_iter=min_it, max_iter=max_it, alpha0=alphas,
                    dtype=getattr(torch, opts.dtype))
        alphas = em.alphas_raw
        total_iters += em.num_iterations
        if em.converged or si == len(segments) - 1:
            break
        t0 = time.time()
        eff = update_effective_lengths(opts, text, bias, pdf_cdf, eff,
                                       alphas, state.num_fwd, state.num_rc)
        synchronize(dev)
        update_seconds.append(time.time() - t0)
    em.num_iterations = total_iters
    return em, eff, update_seconds
