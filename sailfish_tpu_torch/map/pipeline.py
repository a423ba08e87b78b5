"""Device mapping backend: host orchestration of one batch of paired-end
fragments or single-end reads.

Counterpart of sailfish_tpu/map/pipeline.py (`_fused_tail`,
`DeviceMapperBackend`), reads of any length on a 32-bit or a 64-bit
(big_sa) index: the scan runs in the index's width.  Per
batch: reads travel as their uint8 codes through a reused host staging
ring (`StagingRing`); both mates map in one lane block (map/lanes.py);
merge, collapse and the batch counters reduce on the device
(`fused_tail`).  The finishers pull one counter vector, the unique-class
rows and, only for label hashes the accumulator has not seen, the exact
labels.

With --biasCorrect / --gcBiasCorrect the same pass observes the bias
model on the device (stats/bias.py `bias_observe` over the merge's
joint-hit slots): a 6-mer sample per fragment and a GC histogram per
batch, pulled by the host only through `BatchStats`' lazy functions.

Fragments whose candidate set overflowed `hit_capacity` are remapped by
the same scan kernel at `effective_hit_capacity()` (the escalation pass,
`_ESC_ROWS` fragments at a time) and their contribution added, bias
observations included.  `--scanShrink N` compacts both passes as the JAX
package's XLA kernel does (map/shrink.py), over the lane counts of its
batches padded to --batchSize (`_ESC_ROWS` in the escalation pass).  The
JAX package's host-oracle route for that pass does not exist here: the
card holds the wider outputs.

`RefMapperBackend` maps on the host with the numpy reference mapper,
behind the same interface (`quant --backend refimpl`, the oracle).  A
sharded index maps through map/sharded.py's subclass of the device
backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import trace
from ..config import QuantOpts
from ..device import as_device
from ..eqclass.classes import EqClassAccumulator, HashedEqClassAccumulator
from ..index.builder import QuasiIndex, ShardedQuasiIndex
from ..index.device import TorchIndex
from ..io.fastq import FastqBatch
from ..libformat import LibraryFormat, MateStatus, compatible_hit_single
from ..refimpl.mapper import RefMapper
from ..stats.bias import bias_observe, make_bias_text
from .lanes import map_oriented_lanes
from .pair import collapse_unique, merge_and_collapse


def _pull(site: str, t: torch.Tensor) -> np.ndarray:
    """A tensor on the host, the wait timed as the span `sync.<site>`."""
    with trace.sync(site):
        return t.cpu().numpy()


class ShardedIndexRefusal(ValueError):
    """What a run on a sharded index cannot do, raised with the JAX
    package's messages where it raises them (`make_backend` here, the
    sharded backend's constructor); the CLI reports it as a usage
    error."""


@dataclasses.dataclass
class BatchResult:
    """Full per-fragment outcome of one batch (the differential-test
    interface; same fields as the JAX package's BatchResult)."""
    n: int
    labels: list
    label_counts: np.ndarray
    mapped: np.ndarray
    num_joint: np.ndarray
    num_fwd: int
    num_rc: int
    unique_paired: np.ndarray
    frag_lens: np.ndarray
    fmt_counts: np.ndarray
    num_compat: int = 0
    per_read: list | None = None   # refimpl backend: the ReadMappings,
                                   # whose joint hits the bias model replays


@dataclasses.dataclass
class BatchStats:
    """Reduced outcome of one batch: counters plus lazy pulls of the FLD
    detail that is needed only while the first-N gate is open."""
    n: int
    num_mapped: int
    sum_joint: int
    ub_hits: int
    num_fwd: int
    num_rc: int
    fld_count: int
    fmt_counts: np.ndarray
    num_compat: int
    fld_hist: object               # () -> (max_frag_len,) int64
    fld_details: object            # () -> (frag_lens, unique_paired)
    num_escalated: int = 0         # fragments remapped at the wide capacity
    # bias observation (stats/bias.py BiasState.observe_batch)
    seq_samples_fn: object = None  # () -> (n,) int32 6-mer samples, -1 = none
    gc_hist_fn: object = None      # () -> (101,) int64 GC observations
    gc_slots: int = 0              # paired slots that qualified for gc_hist
    per_read: list | None = None   # refimpl backend: the ReadMappings


def fmt_args(expected: LibraryFormat):
    """(orientation, strandedness, 6 single-end compat flags) of the
    expected library format."""
    se_flags = tuple(
        bool(compatible_hit_single(expected, fwd, status))
        for status in (MateStatus.PAIRED_END_LEFT,
                       MateStatus.PAIRED_END_RIGHT,
                       MateStatus.SINGLE_END)
        for fwd in (True, False)
    )
    return (int(expected.orientation), int(expected.strandedness),
            se_flags)


def fused_tail(h1f, h1r, h2f, h2r, l1, l2, expected: LibraryFormat, *,
               paired_end: bool = True, cand_cap: int, max_read_occs: int,
               allow_orphans: bool, allow_dovetail: bool, ignore_compat: bool,
               enforce_compat: bool, strict_intersect: bool,
               max_frag_len: int, bias_text: dict | None = None,
               seq_on: bool = False, gc_on: bool = False) -> dict:
    """merge + collapse + batch reductions, all on the device.
    `scalars` packs the counters into one vector so the per-batch sync is
    a single pull: [0:8] mapped, sum num_joint, fragments with joint
    hits, num_fwd, num_rc, unique classes U, FLD observations,
    library-compatible; [8:72] the observed-format histogram; [72]
    overflowed fragments; [73] paired slots observed for GC bias.  With
    `seq_on` / `gc_on` the joint-hit slots go to `bias_observe` and the
    result carries `seq_samples` and `gc_hist`."""
    orient, strand, se_flags = fmt_args(expected)
    out = merge_and_collapse(
        h1f, h1r, h2f, h2r, l1, l2, orient, strand, se_flags,
        paired_end=paired_end, cand_cap=cand_cap,
        max_read_occs=max_read_occs,
        allow_orphans=allow_orphans, allow_dovetail=allow_dovetail,
        ignore_compat=ignore_compat, enforce_compat=enforce_compat,
        strict_intersect=strict_intersect,
        return_slots=seq_on or gc_on)
    gc_slots = out["mapped"].new_zeros((), dtype=torch.int64)
    bias_out = {}
    if seq_on or gc_on:
        ss, gh, gc_slots = bias_observe(out["slots"], bias_text, l1, l2,
                                        gc_on=gc_on, seq_on=seq_on)
        bias_out = {"seq_samples": ss, "gc_hist": gh}
    uniq, num_u = collapse_unique(out["h1"], out["h2"], out["mapped"],
                                  out["label_len"])
    fl = out["frag_len"]
    sel = out["unique_paired"] & (fl < max_frag_len)
    # a bincount on the card reads its input's least and greatest values
    # on the host
    with trace.sync("bincount", 2):
        fldhist = torch.bincount(torch.where(sel, fl, max_frag_len).long(),
                                 minlength=max_frag_len + 1)[:max_frag_len]
    with trace.sync("bincount", 2):
        fmthist = torch.bincount(
            torch.where(out["mapped"], out["fmt_id"], 64).long(),
            minlength=65)[:64]
    nj = out["num_joint"]
    scalars = torch.cat([
        torch.stack([
            out["mapped"].sum(), nj.sum(), (nj > 0).sum(),
            out["num_fwd"].sum(), out["num_rc"].sum(), num_u.long(),
            sel.sum(), out["have_compat"].sum(),
        ]).long(),
        fmthist.long(),
        out["overflow"].sum().long()[None],
        gc_slots[None],
    ])
    return {
        **bias_out,
        "scalars": scalars,
        "fldhist": fldhist,
        "uniq": uniq,
        "label": out["label"],
        "mapped": out["mapped"],
        "num_joint": nj,
        "unique_paired": out["unique_paired"],
        "frag_len": fl,
        "overflow": out["overflow"],
    }


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32}


def _carve(buf: torch.Tensor, layout) -> list:
    """The arrays of `layout` ((offset, nbytes, dtype, shape) each) as
    views of the byte tensor `buf`."""
    return [buf[o:o + n].view(dt).view(shape) for o, n, dt, shape in layout]


class StagingRing:
    """Host slots a batch's arrays pass through on their way to the
    device.

    Each batch takes the next of two slots: its arrays are written
    into the slot, each in its own region, and the slot goes to the
    device in one copy.  The slots are allocated once and grow to the
    largest batch seen.  On a card they are page-locked, the copy is
    queued (`non_blocking`) and an event marks its end; a slot is written
    again only once its event has passed, and a wait for it is timed as
    `sync.stage` and counted under `map.stage_waits`.  On the CPU nothing
    is pinned and the copy is made at once: a CPU `.to()` would alias the
    slot, which a later batch overwrites while this one may still be
    mapped.  Spans: `map.pack` times the host's part (the wait and the
    writes), `map.copy` the queueing of the copy."""

    ALIGN = 64

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs = [None, None]
        self._events = [None, None]
        self._next = 0

    def stage(self, arrays, ident: int) -> list:
        """Device copies of the numpy `arrays` (uint8 or int32)."""
        k = self._next
        self._next = 1 - k
        layout, end = [], 0
        for a in arrays:
            layout.append((end, a.nbytes, _TORCH_DTYPES[a.dtype], a.shape))
            end += -(-a.nbytes // self.ALIGN) * self.ALIGN
        cuda = self.device.type == "cuda"
        with trace.span("map.pack", ident):
            ev = self._events[k]
            waited = ev is not None and not ev.query()
            if waited:
                with trace.sync("stage"):
                    ev.synchronize()
            trace.count("map.stage_waits", int(waited))
            if self._bufs[k] is None or self._bufs[k].numel() < end:
                self._bufs[k] = torch.empty(end, dtype=torch.uint8,
                                            pin_memory=cuda)
            buf = self._bufs[k][:end]
            for a, h in zip(arrays, _carve(buf, layout)):
                np.copyto(h.numpy(), a)
        with trace.span("map.copy", ident):
            if not cuda:
                return _carve(buf.clone(), layout)
            dev = buf.to(self.device, non_blocking=True)
            if ev is None:
                ev = self._events[k] = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        return _carve(dev, layout)


class DeviceMapperBackend:
    """Mapping on one device.  `submit_pe` (paired-end fragments) and
    `submit_se` (single-end reads) queue a batch and return a token;
    `finish_batch_fast` (production, hash-keyed) or `finish_batch`
    (exact labels, differential tests) syncs on it.  A batch's spans
    (trace.py) carry the id its token holds."""

    _ESC_ROWS = 1024

    def __init__(self, index: QuasiIndex, opts: QuantOpts, device, *,
                 tindex: TorchIndex | None = None,
                 bias_text: dict | None = None):
        self.device = as_device(device)
        self.opts = opts
        self._index = index
        self.tindex = (tindex if tindex is not None
                       else TorchIndex.from_quasi_index(index, self.device))
        self._escb = None
        # the text as the bias model reads it, over the index's tensors;
        # the escalation backend is handed its parent's
        self.bias_text = bias_text
        if bias_text is None and (opts.bias_correct or opts.gc_bias_correct):
            self.bias_text = make_bias_text(index, self.device, opts,
                                            tindex=self.tindex)
        self._ring = StagingRing(self.device)

    @property
    def tail_cap(self) -> int:
        """Width of an oriented hit block in the merge: C here, D x C on
        a sharded index (map/sharded.py)."""
        return self.opts.hit_capacity

    @staticmethod
    def accumulator() -> HashedEqClassAccumulator:
        """The eq-class accumulator `finish_batch_fast` folds into."""
        return HashedEqClassAccumulator()

    # ---- host -> device ----
    def prefetch_pe(self, b1, b2) -> dict:
        """The host half of `submit_pe`: the mates' codes and lengths
        through the staging ring to the device (`b2` None: single-end
        reads)."""
        ident = trace.current_id() or trace.new_id()
        mates = [b for b in (b1, b2) if b is not None]
        dev = self._ring.stage(
            [np.asarray(b.codes, np.uint8) for b in mates]
            + [np.asarray(b.lens, np.int32) for b in mates], ident)
        return {"dev": dev, "n": b1.count, "batches": (b1, b2), "id": ident}

    def prefetch_se(self, b) -> dict:
        """The host half of `submit_se`."""
        return self.prefetch_pe(b, None)

    def _map(self, codes, lens, L, mates=1):
        """The hits of one lane block of `mates` mates' reads.  With
        --scanShrink the compaction's first width is the JAX package's
        lane count: each mate's rows padded to --batchSize, fwd and rc."""
        o = self.opts
        rows = max(codes.shape[0] // mates, o.batch_size)
        return map_oriented_lanes(
            self.tindex, codes, lens, cand_cap=o.hit_capacity,
            max_mmps=o.max_mmps, max_steps=o.effective_scan_steps(L),
            skip_jump=(o.mmp_skip == "jump"), scan_shrink=o.scan_shrink,
            pad_lanes=2 * mates * rows)

    def submit_pe(self, b1, b2, expected: LibraryFormat):
        """Queue one batch on the device (`b2` None: single-end reads);
        returns the token the finishers take.  Its spans take a new id,
        or inside a batch's fold (the escalation pass) that batch's."""
        with trace.span("map.submit", trace.current_id() or trace.new_id()):
            return self.map_prefetched(self.prefetch_pe(b1, b2), expected)

    def submit_se(self, b, expected: LibraryFormat):
        """Queue one batch of single-end reads; same token as
        `submit_pe`."""
        return self.submit_pe(b, None, expected)

    def map_prefetched(self, pf: dict, expected: LibraryFormat):
        """The device half of `submit_pe` / `submit_se`: lanes, scan,
        post-pass, merge, collapse and counters, all queued."""
        with trace.span("map.enqueue", pf.get("id")) as sp:
            res = self._enqueue(pf, expected)
        b1, b2 = pf["batches"]
        return (res, pf["n"], (b1, b2, expected), sp.ident)

    def _enqueue(self, pf: dict, expected: LibraryFormat) -> dict:
        paired_end = pf["batches"][1] is not None
        dev = pf["dev"]
        c1, l1 = dev[0], dev[len(dev) // 2]
        B, L1 = c1.shape

        def part(d, sl):
            return {k: v[sl] for k, v in d.items() if k != "num_mapped_loci"}

        if not paired_end:
            a = self._map(c1, l1, L1)
            h1 = h2 = (part(a, slice(0, B)), part(a, slice(B, 2 * B)))
            l2 = l1
        else:
            c2, l2 = dev[1], dev[3]
            L2 = c2.shape[1]
            if L1 == L2:
                # both mates in one lane block: rows [m1; m2] x [fwd; rc]
                hits = self._map(torch.cat([c1, c2]), torch.cat([l1, l2]),
                                 L1, mates=2)
                h1 = (part(hits, slice(0, B)),
                      part(hits, slice(2 * B, 3 * B)))
                h2 = (part(hits, slice(B, 2 * B)),
                      part(hits, slice(3 * B, 4 * B)))
            else:
                a, b = self._map(c1, l1, L1), self._map(c2, l2, L2)
                h1 = (part(a, slice(0, B)), part(a, slice(B, 2 * B)))
                h2 = (part(b, slice(0, B)), part(b, slice(B, 2 * B)))
        o = self.opts
        return fused_tail(
            h1[0], h1[1], h2[0], h2[1], l1, l2, expected,
            paired_end=paired_end, cand_cap=self.tail_cap,
            max_read_occs=o.max_read_occs,
            allow_orphans=o.allow_orphans, allow_dovetail=o.allow_dovetail,
            ignore_compat=o.ignore_lib_compat,
            enforce_compat=o.enforce_lib_compat,
            strict_intersect=o.strict_intersect,
            max_frag_len=o.max_frag_len, bias_text=self.bias_text,
            seq_on=o.bias_correct, gc_on=o.gc_bias_correct)

    # ---- device -> host ----
    @staticmethod
    def _pull_uniq(res):
        scal = _pull("scalars", res["scalars"])
        U = int(scal[5])
        uniq = _pull("classes", res["uniq"][:U])
        uv = uniq.view(np.uint32)
        keys = (uv[:, 0].astype(np.uint64) << np.uint64(32)) | uv[:, 1]
        return scal, uniq, keys

    @staticmethod
    def _fetch_labels(res, rep_idx, rep_lens):
        if not len(rep_idx):
            return []
        wmax = int(rep_lens.max())
        with trace.sync("label_index"):
            idx = torch.as_tensor(np.asarray(rep_idx, np.int64),
                                  device=res["label"].device)
        block = _pull("labels", res["label"][idx, :max(wmax, 1)])
        trace.count("map.label_bytes", block.nbytes)
        rows = block.tolist()
        return [tuple(r[:n]) for r, n in zip(rows, rep_lens.tolist())]

    # ---- escalation (wide-capacity second pass) ----
    def _esc_enabled(self) -> bool:
        o = self.opts
        return o.hit_capacity_max > 0 and o.hit_capacity_max >= o.hit_capacity

    def _esc_backend(self) -> "DeviceMapperBackend":
        if self._escb is None:
            opts2 = dataclasses.replace(
                self.opts, hit_capacity=self.opts.effective_hit_capacity(),
                hit_capacity_max=0, batch_size=self._ESC_ROWS)
            self._escb = DeviceMapperBackend(self._index, opts2, self.device,
                                             tindex=self.tindex,
                                             bias_text=self.bias_text)
        return self._escb

    def _esc_overflow(self, res, scal, n):
        if not self._esc_enabled() or int(scal[72]) == 0:
            return None
        idx = np.nonzero(_pull("overflow", res["overflow"][:n]))[0]
        return idx if len(idx) else None

    def _esc_chunks(self, ectx, idx):
        b1, b2, expected = ectx
        esc = self._esc_backend()
        for s in range(0, len(idx), self._ESC_ROWS):
            ci = idx[s:s + self._ESC_ROWS]
            sub1 = FastqBatch(b1.codes[ci], b1.lens[ci])
            if b2 is None:
                tok = esc.submit_se(sub1, expected)
            else:
                tok = esc.submit_pe(
                    sub1, FastqBatch(b2.codes[ci], b2.lens[ci]), expected)
            yield ci, esc, tok

    def finish_batch_fast(self, token, acc) -> BatchStats:
        """Fold the batch's eq classes into `acc` (a
        HashedEqClassAccumulator) and return its counters.  Counts
        (trace.py) the classes pulled (`map.fold_classes`), those new to
        `acc` (`map.new_classes`) and the bytes of their labels pulled
        (`map.label_bytes`); an escalation pass counts its own."""
        with trace.span("map.fold", token[3]):
            return self._fold(token, acc)

    def _fold(self, token, acc) -> BatchStats:
        res, n, ectx, _ = token
        with trace.span("map.pull"):
            scal, uniq, keys = self._pull_uniq(res)
        trace.count("map.fold_classes", len(uniq))
        with trace.span("map.fold_host"):
            counts = uniq[:, 2].astype(np.int64)
            new = acc.add_hashed(keys, counts)
        trace.count("map.new_classes", int(new.sum()))
        if new.any():
            with trace.span("map.labels"):
                labels = self._fetch_labels(res, uniq[new, 3], uniq[new, 4])
            with trace.span("map.fold_host"):
                acc.register_new(keys[new], labels, counts[new])
        bs = BatchStats(
            n=n, num_mapped=int(scal[0]), sum_joint=int(scal[1]),
            ub_hits=int(scal[2]), num_fwd=int(scal[3]),
            num_rc=int(scal[4]), fld_count=int(scal[6]),
            fmt_counts=scal[8:72].astype(np.int64), num_compat=int(scal[7]),
            fld_hist=lambda: _pull("fld", res["fldhist"]).astype(
                np.int64),
            fld_details=lambda: (_pull("fld", res["frag_len"][:n]),
                                 _pull("fld", res["unique_paired"][:n])),
            gc_slots=int(scal[73]),
        )
        if self.opts.bias_correct:
            bs.seq_samples_fn = lambda: _pull("bias",
                                              res["seq_samples"][:n])
        if self.opts.gc_bias_correct:
            bs.gc_hist_fn = lambda: _pull("bias", res["gc_hist"])
        idx = self._esc_overflow(res, scal, n)
        if idx is None:
            return bs
        bs.num_escalated = len(idx)
        with trace.span("map.escalate"):
            self._fold_escalated(bs, ectx, idx, acc)
        return bs

    def _fold_escalated(self, bs: BatchStats, ectx, idx, acc) -> None:
        for ci, esc, tok in self._esc_chunks(ectx, idx):
            # overflowed fragments contributed nothing to the main pass,
            # so the wide pass's counters add
            sub = esc.finish_batch_fast(tok, acc)
            bs.num_mapped += sub.num_mapped
            bs.sum_joint += sub.sum_joint
            bs.ub_hits += sub.ub_hits
            bs.num_fwd += sub.num_fwd
            bs.num_rc += sub.num_rc
            bs.fld_count += sub.fld_count
            bs.fmt_counts = bs.fmt_counts + sub.fmt_counts
            bs.num_compat += sub.num_compat
            bs.fld_hist = lambda a=bs.fld_hist, b=sub.fld_hist: a() + b()

            def details(a=bs.fld_details, b=sub.fld_details, ci=ci):
                fls, up = (x.copy() for x in a())
                fls[ci], up[ci] = b()
                return fls, up

            bs.fld_details = details
            # an overflowed fragment gave no sample in the main pass: it
            # takes the wide pass's, in its place in file order
            if bs.seq_samples_fn is not None:
                def samples(a=bs.seq_samples_fn, b=sub.seq_samples_fn,
                            ci=ci):
                    out = a().copy()
                    out[ci] = b()
                    return out

                bs.seq_samples_fn = samples
            if bs.gc_hist_fn is not None:
                bs.gc_hist_fn = (
                    lambda a=bs.gc_hist_fn, b=sub.gc_hist_fn: a() + b())
                bs.gc_slots += sub.gc_slots

    def finish_batch(self, token) -> BatchResult:
        """Full-detail finish: exact labels for every class and the
        per-fragment vectors."""
        res, n, ectx, _ = token
        scal, uniq, _ = self._pull_uniq(res)
        br = BatchResult(
            n=n,
            labels=self._fetch_labels(res, uniq[:, 3], uniq[:, 4]),
            label_counts=uniq[:, 2].astype(np.int64),
            mapped=res["mapped"][:n].cpu().numpy(),
            num_joint=res["num_joint"][:n].cpu().numpy(),
            num_fwd=int(scal[3]), num_rc=int(scal[4]),
            unique_paired=res["unique_paired"][:n].cpu().numpy(),
            frag_lens=res["frag_len"][:n].cpu().numpy(),
            fmt_counts=scal[8:72].astype(np.int64),
            num_compat=int(scal[7]),
        )
        idx = self._esc_overflow(res, scal, n)
        if idx is None:
            return br
        lab = dict(zip(br.labels, br.label_counts.tolist()))
        for ci, esc, tok in self._esc_chunks(ectx, idx):
            sub = esc.finish_batch(tok)
            for t, c in zip(sub.labels, sub.label_counts.tolist()):
                lab[t] = lab.get(t, 0) + c
            br.mapped[ci] = sub.mapped
            br.num_joint[ci] = sub.num_joint
            br.unique_paired[ci] = sub.unique_paired
            br.frag_lens[ci] = sub.frag_lens
            br.num_fwd += sub.num_fwd
            br.num_rc += sub.num_rc
            br.fmt_counts = br.fmt_counts + sub.fmt_counts
            br.num_compat += sub.num_compat
        br.labels = list(lab.keys())
        br.label_counts = np.array(list(lab.values()), dtype=np.int64)
        return br

    def map_pe_batch(self, b1, b2, expected: LibraryFormat) -> BatchResult:
        return self.finish_batch(self.submit_pe(b1, b2, expected))

    def map_se_batch(self, b, expected: LibraryFormat) -> BatchResult:
        return self.finish_batch(self.submit_se(b, expected))


# the fragment mapper of the batch a forked worker maps (_map_span)
_FORKED_ONE = None


def _map_span(span):
    return [_FORKED_ONE(i) for i in range(*span)]


class RefMapperBackend:
    """Host mapping with the numpy reference mapper, the correctness
    oracle (`--backend refimpl`), behind the device backend's interface.
    Mapping is synchronous: the token is the batch's BatchResult, and
    eq classes fold by exact label.  With `workers` > 1 a batch's
    fragments are mapped in that many forked processes, spans of them in
    order, which share the index with this one (each fragment maps on
    its own, so the result is the same)."""

    def __init__(self, index: QuasiIndex, opts: QuantOpts,
                 workers: int = 1):
        self.opts = opts
        self.mapper = RefMapper(index, opts)
        self.workers = workers

    @staticmethod
    def accumulator() -> EqClassAccumulator:
        return EqClassAccumulator()

    def _map_all(self, one, n: int) -> list:
        if self.workers <= 1 or n < 2 * self.workers:
            return [one(i) for i in range(n)]
        import multiprocessing

        global _FORKED_ONE
        edges = np.linspace(0, n, 4 * self.workers + 1).astype(int)
        _FORKED_ONE = one
        try:
            with multiprocessing.get_context("fork").Pool(
                    self.workers) as pool:
                parts = pool.map(_map_span, list(zip(edges[:-1],
                                                     edges[1:])), 1)
        finally:
            _FORKED_ONE = None
        return [rm for part in parts for rm in part]

    def map_pe_batch(self, b1, b2, expected: LibraryFormat) -> BatchResult:
        return self._wrap(self._map_all(
            lambda i: self.mapper.map_fragment_pe(
                b1.codes[i, :b1.lens[i]], b2.codes[i, :b2.lens[i]],
                expected), b1.count))

    def map_se_batch(self, b, expected: LibraryFormat) -> BatchResult:
        return self._wrap(self._map_all(
            lambda i: self.mapper.map_fragment_se(b.codes[i, :b.lens[i]],
                                                  expected), b.count))

    @staticmethod
    def _wrap(rms) -> BatchResult:
        counts: dict = {}
        fmt_counts = np.zeros(64, dtype=np.int64)
        for rm in rms:
            if rm.label is not None:
                counts[rm.label] = counts.get(rm.label, 0) + 1
            if rm.fmt_id >= 0:
                fmt_counts[rm.fmt_id] += 1
        return BatchResult(
            n=len(rms),
            labels=list(counts.keys()),
            label_counts=np.array(list(counts.values()), dtype=np.int64),
            mapped=np.array([rm.label is not None for rm in rms], dtype=bool),
            num_joint=np.array([rm.num_joint_hits for rm in rms],
                               dtype=np.int64),
            num_fwd=sum(rm.num_fwd for rm in rms if rm.label is not None),
            num_rc=sum(rm.num_rc for rm in rms if rm.label is not None),
            unique_paired=np.array([rm.unique_paired for rm in rms],
                                   dtype=bool),
            frag_lens=np.array([rm.frag_len for rm in rms], dtype=np.int64),
            fmt_counts=fmt_counts,
            num_compat=sum(int(rm.compat) for rm in rms),
            per_read=rms,
        )

    submit_pe = map_pe_batch
    submit_se = map_se_batch

    @staticmethod
    def finish_batch(token) -> BatchResult:
        return token

    def finish_batch_fast(self, token, acc) -> BatchStats:
        br = token
        known = len(acc)
        acc.add_many(br.labels, br.label_counts)
        trace.count("map.new_classes", len(acc) - known)
        mfl = self.opts.max_frag_len
        sel = br.unique_paired & (br.frag_lens < mfl)
        return BatchStats(
            n=br.n, num_mapped=int(br.mapped.sum()),
            sum_joint=int(br.num_joint.sum()),
            ub_hits=int((br.num_joint > 0).sum()), num_fwd=br.num_fwd,
            num_rc=br.num_rc, fld_count=int(sel.sum()),
            fmt_counts=br.fmt_counts, num_compat=br.num_compat,
            fld_hist=lambda: np.bincount(br.frag_lens[sel],
                                         minlength=mfl)[:mfl],
            fld_details=lambda: (br.frag_lens, br.unique_paired),
            per_read=br.per_read,
        )


def make_backend(index, opts: QuantOpts, device, backend: str = "device"):
    """The mapping backend for `quant --backend`: "device" maps on
    `device`; "refimpl" maps on the host with the reference mapper.  A
    sharded index (index/builder.py ShardedQuasiIndex) maps with every
    shard on `device` (map/sharded.py) and refuses "refimpl", as the JAX
    package does (sailfish_tpu/quant.py make_backend)."""
    if isinstance(index, ShardedQuasiIndex):
        if backend != "device":
            raise ShardedIndexRefusal("a sharded index maps on the device "
                                      "mesh only (--backend device)")
        from .sharded import ShardedMapperBackend

        return ShardedMapperBackend(index, opts, [device])
    if backend == "device":
        return DeviceMapperBackend(index, opts, device)
    if backend == "refimpl":
        return RefMapperBackend(index, opts)
    raise ValueError(f"unknown mapping backend: {backend}")
