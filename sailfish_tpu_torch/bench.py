"""Throughput benchmark of the port: ``python -m sailfish_tpu_torch.bench``.

Counterpart of the JAX package's two throughput tools, one switch:

  --world uniform   bench.py: 20,000 random transcripts of 1,000 +
                    50 (i mod 7) bases (numpy seed 0), 12 x 65,536
                    paired 100 bp fragments pre-simulated from the same
                    generator (lengths uniform in [130, 320), mate 2
                    reverse-complemented, 0.5 % substitutions); the
                    one-deep pipeline timed from the first prefetch to
                    the last fold: `reads_per_sec_per_chip` (reads/s);
                    EM iterations/s on stderr.
  --world gencode   tools/bench_gencode.py (BASELINE.md configs 2 and 3):
                    a gene-family transcriptome of ~200k transcripts and
                    ~150 Mb (seed 7), 10M paired fragments of length
                    N(250, 25) simulated batch by batch (seed 11) outside
                    the timed region; `gencode_index_build_s` or
                    `gencode_index_load_s`, `gencode_reads_per_sec`
                    (frags/s, the summed time of `submit_pe` plus
                    `finish_batch_fast`), `gencode_em_iters_per_sec`,
                    and with --bootstraps / --gibbs
                    `gencode_bootstraps_per_sec` and
                    `gencode_gibbs_samples_per_sec`.

Both map at --hitCapacity 64 --hitCapacityMax 1024 (the CLI defaults),
and run the EM in float32 (min 50 iterations, max 200 or 1,000) on the
collapsed classes with effective lengths max(len - 220, 1), once
untimed and once timed.  The worlds and reads are those of the JAX tools
bit for bit at the same sizes and seeds.

Before any metric line, `--check N` (2,048) maps the first N fragments
of the first batch through the device backend and through the numpy
reference mapper (`--backend refimpl`'s `RefMapperBackend`): eq-class
labels and counts must be equal and the sample's EM alphas must sum to
its mapped count, else the run exits 1.  `--breakdown` runs, after the
timed loop, one pipelined pass under torch.profiler (`stage_breakdown`):
each stage's host ms a batch from the port's spans (trace.py) and the
device's busy time against the wall time.

stdout holds one JSON line per metric, {"metric", "value", "unit", ...};
the narrative, the card's name and power limit (nvidia-smi) and the
breakdown go to stderr.  The bench runs on the CUDA card unless
`--device cpu` asks for the CPU (the kernels' plain versions); without a
card the default fails with device.py `as_device`'s error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import trace
from .config import QuantOpts
from .device import as_device, synchronize
from .eqclass.classes import EqClasses
from .index.builder import build_index, load_index, save_index
from .index.device import TorchIndex
from .infer.em import run_em
from .io.fastq import FastqBatch
from .libformat import parse_library_format
from .map.pipeline import DeviceMapperBackend, RefMapperBackend
from .ubench import card_line

READ_LEN = 100
ERR = 0.005
GENCODE_WORLD_SEED = 7
DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache")
# flags of one world only, with that world's defaults (the JAX tools')
WORLD_FLAGS = {
    "uniform": dict(seed=0, txps=20_000, txp_len=1000, read_len=READ_LEN,
                    err=ERR, batches=12),
    "gencode": dict(seed=11, txps=200_000, bases=150e6, reads=10_000_000,
                    index_dir=None, bootstraps=0, gibbs=0),
}


class CheckFailure(Exception):
    """An output that disagrees with its reference."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require(cond, msg):
    if not cond:
        raise CheckFailure(msg)


# ---------------------------------------------------------------- worlds
def uniform_seqs(rng, txps: int, txp_len: int) -> list:
    """bench.py build_world's transcripts: `txps` random sequences of
    txp_len + 50 (i mod 7) bases, drawn one after the other from `rng`."""
    return [rng.integers(0, 4, txp_len + 50 * (i % 7)).astype(np.uint8)
            for i in range(txps)]


def simulate_uniform(seqs, rng, batches: int, batch: int,
                     read_len: int = READ_LEN, err: float = ERR) -> list:
    """bench.py simulate_batches: `batches` x (c1, c2, lens) of `batch`
    paired fragments, codes padded with 4 to a multiple of 8."""
    L = (read_len + 7) // 8 * 8
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    concat = np.concatenate(seqs)
    lens_arr = np.array([len(s) for s in seqs])
    out = []
    for _ in range(batches):
        t = rng.integers(0, len(seqs), batch)
        fl = rng.integers(read_len + 30, 320, batch)
        fl = np.minimum(fl, lens_arr[t])
        p = (rng.random(batch) * (lens_arr[t] - fl + 1)).astype(np.int64)
        start = offsets[t] + p
        m1 = concat[start[:, None] + np.arange(read_len)]
        i2 = start[:, None] + (fl[:, None] - read_len) + np.arange(read_len)
        m2 = (3 - concat[i2][:, ::-1]).astype(np.uint8)
        if err > 0:
            for m in (m1, m2):
                mask = rng.random(m.shape) < err
                m[mask] = (m[mask] + rng.integers(1, 4, mask.sum())) % 4
        c1 = np.full((batch, L), 4, np.uint8)
        c2 = np.full((batch, L), 4, np.uint8)
        c1[:, :read_len] = m1
        c2[:, :read_len] = m2
        out.append((c1, c2, np.full(batch, read_len, np.int32)))
    return out


def build_transcriptome(rng, txps: int, bases: float):
    """Gene-family transcriptome (tools/bench_gencode.py): genes of 4-13
    exons of 30-200 bases; each of 1-8 isoforms keeps each exon with
    probability 0.8, so family members share most of their sequence."""
    seqs, names = [], []
    total = 0
    gene = 0
    while len(seqs) < txps and total < bases:
        n_ex = int(rng.integers(4, 14))
        exons = [rng.integers(0, 4, int(rng.integers(30, 201)))
                 .astype(np.uint8) for _ in range(n_ex)]
        n_iso = int(min(rng.integers(1, 9), txps - len(seqs)))
        for i in range(n_iso):
            keep = rng.random(n_ex) < 0.8
            keep[rng.integers(0, n_ex)] = True
            s = np.concatenate([e for e, k in zip(exons, keep) if k])
            if len(s) < READ_LEN + 60:
                s = np.concatenate([s, rng.integers(0, 4, READ_LEN + 60)
                                    .astype(np.uint8)])
            seqs.append(s)
            names.append(f"g{gene}.i{i}")
            total += len(s)
        gene += 1
    return names, seqs


def simulate_batch(rng, concat, offs, lens, n, read_len=READ_LEN):
    """n fragments: transcript uniform, length ~N(250, 25) clipped to
    [read_len + 10, 600] and to the transcript, mate 2
    reverse-complemented, substitutions at rate ERR
    (tools/bench_gencode.py simulate_batch); the mates unpadded."""
    t = rng.integers(0, len(lens), n)
    fl = np.clip(rng.normal(250, 25, n).astype(np.int64), read_len + 10, 600)
    fl = np.minimum(fl, lens[t])
    p = (rng.random(n) * (lens[t] - fl + 1)).astype(np.int64)
    start = offs[t] + p
    m1 = concat[start[:, None] + np.arange(read_len)]
    i2 = start[:, None] + (fl[:, None] - read_len) + np.arange(read_len)
    m2 = (3 - concat[i2][:, ::-1]).astype(np.uint8)
    for m in (m1, m2):
        mask = rng.random(m.shape) < ERR
        m[mask] = (m[mask] + rng.integers(1, 4, mask.sum())) % 4
    return m1, m2


def padded(m):
    """(n, read_len) codes -> (n, L) padded with code 4, L a multiple
    of 8 (the FASTQ reader's batch layout)."""
    L = (m.shape[1] + 7) // 8 * 8
    codes = np.full((m.shape[0], L), 4, np.uint8)
    codes[:, :m.shape[1]] = m
    return codes


def fastq_batch(m) -> FastqBatch:
    return FastqBatch(padded(m), np.full(m.shape[0], m.shape[1], np.int32))


def fastq_pair(c1, c2, lens):
    return FastqBatch(c1, lens), FastqBatch(c2, lens)


def _world_arrays(seqs):
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return np.concatenate(seqs), offs, lens


def _same_world(index, lens) -> bool:
    return (index.num_transcripts == len(lens)
            and np.array_equal(np.asarray(index.txp_lens), lens))


def uniform_world(args):
    """bench.py build_world: the transcripts from numpy seed `args.seed`
    and their k = 31 index, cached under `args.cache`; then the batches
    from the same generator.  Returns (index, batches)."""
    rng = np.random.default_rng(args.seed)
    log(f"building synthetic transcriptome: {args.txps} x "
        f"~{args.txp_len}bp")
    t0 = time.time()
    seqs = uniform_seqs(rng, args.txps, args.txp_len)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    cdir = (os.path.join(args.cache, f"uniform_{args.seed}_{args.txps}_"
                                     f"{args.txp_len}") if args.cache else "")
    idx = None
    if cdir and os.path.exists(os.path.join(cdir, "header.json")):
        idx = load_index(cdir)
        if _same_world(idx, lens):
            log(f"loaded cached index {cdir} in {time.time() - t0:.1f}s")
        else:
            log(f"cached index {cdir} is of another world; rebuilding")
            idx = None
    if idx is None:
        idx = build_index([f"t{i}" for i in range(args.txps)], seqs, k=31)
        log(f"index built in {time.time() - t0:.1f}s "
            f"(N={idx.text_len}, P={idx.prefix_bases})")
        if cdir:
            save_index(idx, cdir)
    t0 = time.time()
    batches = simulate_uniform(seqs, rng, args.batches, args.batch,
                               args.read_len, args.err)
    log(f"simulated {args.batches} x {args.batch} read pairs in "
        f"{time.time() - t0:.1f}s")
    return idx, batches


def gencode_world(args):
    """tools/bench_gencode.py get_world: the gene-family world of seed 7
    and its k = 31 index.  The index comes from --index-dir (an index of
    this world: the transcripts are read from a world.npz beside it, as
    the JAX tool keeps them, or made again from the seed), from the cache
    or from a build.  Returns (index, concat, offs, lens, setup) with
    offs the transcripts' starts and setup the set-up metric's
    (name, seconds, extra keys)."""
    cdir = (os.path.join(args.cache, f"gencode_{args.txps}_{int(args.bases)}")
            if args.cache else "")
    src = args.index_dir or cdir
    if src and os.path.exists(os.path.join(src, "header.json")):
        t0 = time.time()
        idx = load_index(src)
        npz = os.path.join(src, "world.npz")
        if os.path.exists(npz):
            with np.load(npz, allow_pickle=False) as z:
                concat, offs, lens = z["concat"], z["offs"], z["lens"]
            world = "world.npz"
        else:
            _, seqs = build_transcriptome(
                np.random.default_rng(GENCODE_WORLD_SEED), args.txps,
                args.bases)
            concat, offs, lens = _world_arrays(seqs)
            del seqs
            world = f"regenerated from seed {GENCODE_WORLD_SEED}"
        dt = time.time() - t0
        require(_same_world(idx, lens),
                f"the index at {src} is not of this world ({args.txps} "
                f"transcripts, {args.bases:.0f} bases at most)")
        log(f"loaded index {src} in {dt:.1f}s (transcripts: {world})")
        return (idx, concat, offs[:-1], lens,
                ("gencode_index_load_s", dt, {"world": world}))
    log(f"building gene-family transcriptome (~{args.txps} txps, "
        f"~{args.bases / 1e6:.0f}Mb)")
    names, seqs = build_transcriptome(
        np.random.default_rng(GENCODE_WORLD_SEED), args.txps, args.bases)
    concat, offs, lens = _world_arrays(seqs)
    log(f"  {len(seqs)} transcripts, {lens.sum() / 1e6:.1f}Mb")
    t0 = time.time()
    idx = build_index(names, seqs, k=31)
    dt = time.time() - t0
    log(f"index built in {dt:.1f}s (N={idx.text_len})")
    if cdir:
        save_index(idx, cdir)
        np.savez(os.path.join(cdir, "world.npz"), concat=concat, offs=offs,
                 lens=lens)
    return (idx, concat, offs[:-1], lens,
            ("gencode_index_build_s", dt,
             {"text_mb": round(idx.text_len / 1e6, 1)}))


# ---------------------------------------------------------------- checks
def oracle_check(index, tidx, mates, lib, caps, cap_max=1024, out=log,
                 workers=1):
    """Eq classes of a sample from the device backend against the
    refimpl backend (the numpy reference mapper, in `workers` forked
    processes).  `mates` is (m1, m2) for a paired library or (m,) for a
    single-end one, unpadded; `caps` the --hitCapacity values to run.
    Returns the oracle's BatchResult."""
    exp = parse_library_format(lib)
    bs = tuple(fastq_batch(m) for m in mates)
    n, rl = mates[0].shape
    what = (f"{n} paired {rl} bp fragments" if len(bs) == 2
            else f"{n} single-end {rl} bp reads")

    def run(be):
        return be.submit_pe(*bs, exp) if len(bs) == 2 \
            else be.submit_se(*bs, exp)

    # C = 64 is the main pass; C = 2 overflows every multi-isoform seed
    # and sends those fragments through the escalation pass at 1024 —
    # both must give the oracle's classes (its envelope is cap_max either
    # way)
    ports = {}
    for cap in caps:
        opts = QuantOpts(hit_capacity=cap, hit_capacity_max=cap_max)
        port = DeviceMapperBackend(index, opts, tidx.device, tindex=tidx)
        t0 = time.time()
        tok = run(port)
        escalated = int(tok[0]["scalars"][72])
        br = port.finish_batch(tok)
        ports[cap] = (br, escalated, time.time() - t0)
    t0 = time.time()
    oracle = RefMapperBackend(index, QuantOpts(hit_capacity=64,
                                               hit_capacity_max=cap_max),
                              workers=workers)
    ref_br = oracle.finish_batch(run(oracle))
    ref = dict(zip(ref_br.labels, ref_br.label_counts.tolist()))
    t_ref = time.time() - t0
    require(int(ref_br.mapped.sum()) > 0, f"oracle -l {lib}: nothing mapped")
    for cap, (br, escalated, t_port) in ports.items():
        got = dict(zip(br.labels, br.label_counts.tolist()))
        require(got == ref, f"-l {lib} --hitCapacity {cap}: eq classes "
                f"differ from the oracle: "
                f"{len(set(got.items()) ^ set(ref.items()))} (label, count) "
                "pairs")
        require(np.array_equal(br.mapped, ref_br.mapped),
                f"-l {lib} --hitCapacity {cap}: mapped flags differ")
        out(f"oracle -l {lib}: {what} at --hitCapacity {cap} "
            f"--hitCapacityMax {cap_max} ({escalated} escalated): {len(ref)} "
            f"eq classes, {int(ref_br.mapped.sum())} mapped, identical to "
            f"the refimpl backend (port {t_port:.2f}s, oracle {t_ref:.1f}s)")
    if 2 in ports:
        require(ports[2][1] > 0, "the C = 2 pass escalated no fragment")
    return ref_br


def require_alpha_sum(em, eq, what):
    """The EM's alphas must be finite and sum to the classes' count of
    mapped fragments (rtol 1e-4, float32)."""
    s, total = float(em.alphas.sum()), eq.total_count()
    require(np.isfinite(em.alphas).all() and abs(s - total) <= 1e-4 * total,
            f"{what}: EM alphas sum to {s}, not to the {total} mapped "
            "fragments")


def effective_lengths(index) -> np.ndarray:
    return np.maximum(index.txp_lens.astype(np.float64) - 220.0, 1.0)


def device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


# a batch's stages, as the port's spans name them (trace.py)
STAGES = ("map.submit", "map.pack", "map.copy", "map.enqueue", "map.fold",
          "map.pull", "map.labels", "map.fold_host")


def stage_breakdown(index, tidx, batches, card, out=log):
    """Where a batch's time goes at the main path's batch size.
    `batches` is a list of (m1, m2) unpadded mates, run as quant runs
    them (one-deep pipeline, no extra syncs) under torch.profiler.  The
    port's records of that pass (trace.py) give each stage's host ms a
    batch (`map.enqueue` without the host syncs inside it, which the
    `sync` line sums with their count); the profiler gives the device's
    busy time against the wall time.  Returns the scan kernel's ms a
    launch, None when no device time was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    exp = parse_library_format("IU")
    dev = tidx.device
    be = DeviceMapperBackend(index, QuantOpts(hit_capacity=64,
                                              hit_capacity_max=1024),
                             dev, tindex=tidx)
    fq = [tuple(fastq_batch(m) for m in b) for b in batches]
    acc = be.accumulator()
    synchronize(dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    first = len(trace.records())
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pending = None
        for b1, b2 in fq:
            tok = be.submit_pe(b1, b2, exp)
            if pending is not None:
                be.finish_batch_fast(pending, acc)
            pending = tok
        be.finish_batch_fast(pending, acc)
        synchronize(dev)
        wall_us = 1e6 * (time.perf_counter() - t0)
    per, syncs = {}, {}
    for r in trace.records()[first:]:
        stage = "sync" if r.name.startswith("sync.") else r.name
        d = per.setdefault(stage, {})
        d[r.ident] = d.get(r.ident, 0) + (
            r.self_ns if stage == "map.enqueue" else r.ns)
        if stage == "sync":
            syncs[r.ident] = syncs.get(r.ident, 0) + r.counts["syncs"]
    ids = list(per.get("map.submit", {}))
    steady = ids[1:] if len(ids) > 1 else ids
    for stage in STAGES + ("sync",):
        ms = {i: 1e-6 * per.get(stage, {}).get(i, 0) for i in ids}
        out(f"stage {stage}: median "
            f"{np.median([ms[i] for i in steady]):.3f} ms over batches "
            f"2..{len(ids)} (all: {', '.join(f'{ms[i]:.3f}' for i in ids)}) "
            f"[{fq[0][0].count} fragments/batch, {card}]")
    out(f"stage sync: host syncs a batch "
        f"{', '.join(str(syncs.get(i, 0)) for i in ids)}")

    # device-side events only (kernels, copies, fills): an operator's
    # own entry repeats the time of the kernels it launched
    evts = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and device_us(e) > 0), key=device_us, reverse=True)
    busy_us = sum(device_us(e) for e in evts)
    if not evts:
        out("profile: not measured (torch.profiler recorded no device "
            "time)")
        return None
    scan = [e for e in evts if "mmp_scan" in e.key]
    scan_us = sum(device_us(e) for e in scan)
    out(f"profile: {len(fq)} batches pipelined as quant runs them: wall "
        f"{wall_us / 1e3:.3f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%); scan kernel "
        f"{scan_us / 1e3:.3f} ms ({100 * scan_us / busy_us:.1f}% of busy) "
        f"[{card}]")
    for e in evts[:8]:
        out(f"profile kernel: {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    # the scan kernel alone, as the profiler times it inside the pipeline
    return scan_us / 1e3 / max(sum(e.count for e in scan), 1)


# ---------------------------------------------------------------- runs
class Bench:
    """One run: the device, the card, the options and the metric lines."""

    def __init__(self, args):
        self.args = args
        self.dev = as_device(args.device)
        self.card = card_line() if self.dev.type == "cuda" else "cpu"
        self.opts = QuantOpts(batch_size=args.batch,
                              hit_capacity=args.hitCapacity,
                              hit_capacity_max=args.hitCapacityMax)
        self.expected = parse_library_format("IU")

    def emit(self, metric, value, unit, **extra):
        doc = {"metric": metric, "value": float(value), "unit": unit,
               **extra, "device": self.dev.type, "card": self.card}
        print(json.dumps(doc), flush=True)
        log("  ->", doc)

    def prepare(self, index):
        """The kernels' first-use build and the index upload, each timed
        apart; returns (TorchIndex, backend)."""
        if self.dev.type == "cuda":
            from . import _ext

            t0 = time.time()
            kl = _ext.load()
            log(f"kernel library: {kl.path.name}, nvcc "
                f"{kl.build_seconds:.2f}s ({time.time() - t0:.2f}s with "
                "load; 0 when built before)")
        t0 = time.time()
        tidx = TorchIndex.from_quasi_index(index, self.dev)
        synchronize(self.dev)
        log(f"index upload: {time.time() - t0:.2f}s "
            f"({tidx.n_text} text positions)")
        return tidx, DeviceMapperBackend(index, self.opts, self.dev,
                                         tindex=tidx)

    def check(self, index, tidx, m1, m2):
        """--check: the first N fragments of the first batch against the
        reference mapper, and the EM on their classes."""
        n = self.args.check
        if n <= 0:
            return 0
        # on the card the host's cores are free for the oracle
        ref = oracle_check(index, tidx, (m1[:n], m2[:n]), "IU",
                           (self.args.hitCapacity,), self.args.hitCapacityMax,
                           workers=((os.cpu_count() or 1)
                                    if self.dev.type == "cuda" else 1))
        eq = EqClasses.from_items(list(zip(ref.labels, ref.label_counts)))
        em = run_em(eq, effective_lengths(index), float(eq.total_count()),
                    index.num_transcripts, device=self.dev,
                    dtype=torch.float32)
        require_alpha_sum(em, eq, f"--check {n}")
        return min(n, len(m1))

    def em(self, index, acc, mapped, max_iter):
        """The EM on the collapsed classes, once untimed and once timed;
        returns (eq, result, seconds of the timed run)."""
        eq = acc.finish()
        eff = effective_lengths(index)
        for _ in range(2):
            synchronize(self.dev)
            t0 = time.time()
            em = run_em(eq, eff, float(mapped), index.num_transcripts,
                        device=self.dev, dtype=torch.float32, min_iter=50,
                        max_iter=max_iter)
            dt = time.time() - t0
        require_alpha_sum(em, eq, "EM")
        return eq, em, dt


def run_uniform(b: Bench):
    """bench.py: the warm-up, the timed pipeline, the EM.  Returns the
    collapsed classes and the EMResult (None with --build-only)."""
    args = b.args
    index, batches = uniform_world(args)
    if args.build_only:
        return
    log(f"simulated on {b.dev.type} ({b.card})")
    tidx, backend = b.prepare(index)
    rl = args.read_len
    checked = b.check(index, tidx, batches[0][0][:, :rl],
                      batches[0][1][:, :rl])

    # warm-up: two batches against ONE accumulator (the first all new
    # classes, the second few new), the timed loop's shapes
    t0 = time.time()
    acc_w = backend.accumulator()
    for c1, c2, lens in batches[:2]:
        bs = backend.finish_batch_fast(
            backend.submit_pe(*fastq_pair(c1, c2, lens), b.expected), acc_w)
    log(f"warmup {time.time() - t0:.1f}s; mapped {bs.num_mapped}/"
        f"{args.batch}")

    # one-deep pipeline as quant's mapping loop runs it: batch n+1 staged and
    # copied right after batch n's device work is queued, then batch n-1
    # folded on the host
    acc = backend.accumulator()
    launches0 = trace.counter("launch.mmp_scan")
    batch_ms = []
    total = mapped = 0
    pending = None
    synchronize(b.dev)
    t0 = tb = time.perf_counter()
    pf = backend.prefetch_pe(*fastq_pair(*batches[0]))
    for i in range(len(batches)):
        token = backend.map_prefetched(pf, b.expected)
        if i + 1 < len(batches):
            pf = backend.prefetch_pe(*fastq_pair(*batches[i + 1]))
        if pending is not None:
            bs = backend.finish_batch_fast(pending, acc)
            total += bs.n
            mapped += bs.num_mapped
            now = time.perf_counter()
            batch_ms.append(1e3 * (now - tb))
            log(f"  batch {total // args.batch}: {batch_ms[-1]:.1f} ms, "
                f"{len(acc)} classes")
            tb = now
        pending = token
    bs = backend.finish_batch_fast(pending, acc)
    total += bs.n
    mapped += bs.num_mapped
    synchronize(b.dev)
    now = time.perf_counter()
    batch_ms.append(1e3 * (now - tb))
    dt = now - t0
    launches = trace.counter("launch.mmp_scan") - launches0
    log(f"  batch {total // args.batch}: {batch_ms[-1]:.1f} ms, "
        f"{len(acc)} classes")
    log(f"mapped {mapped}/{total} in {dt:.3f}s -> {total / dt:,.0f} "
        f"reads/s; {len(acc)} eq classes; scan kernel launches {launches}")

    if args.breakdown:
        stage_breakdown(index, tidx, [(c1[:, :rl], c2[:, :rl])
                                      for c1, c2, _ in batches[:2]], b.card)
    eq, em, em_dt = b.em(index, acc, mapped, max_iter=200)
    log(f"EM: {em.num_iterations} iters in {em_dt:.3f}s "
        f"({em.num_iterations / max(em_dt, 1e-9):,.1f} iters/s); "
        f"{eq.num_classes} eq classes")
    b.emit("reads_per_sec_per_chip", total / dt, "reads/s", reads=total,
           mapped=mapped, eq_classes=len(acc), seconds=dt,
           batch_ms=[round(x, 3) for x in batch_ms],
           scan_launches=launches, checked=checked)
    return eq, em


def run_gencode(b: Bench):
    """tools/bench_gencode.py: the warm-up batch, the timed mapping (the
    simulation of batch n+1 outside the timed region, while the device
    maps batch n), the EM, the samplers."""
    args = b.args
    index, concat, offs, lens, (name, setup_s, extra) = gencode_world(args)
    if args.build_only:
        b.emit(name, setup_s, "s", **extra)
        return
    log(f"device={b.dev.type} ({b.card}) batch={args.batch}")
    tidx, backend = b.prepare(index)
    rng = np.random.default_rng(args.seed)

    def simulate():
        m1, m2 = simulate_batch(rng, concat, offs, lens, args.batch)
        return (padded(m1), padded(m2),
                np.full(args.batch, READ_LEN, np.int32)), (m1, m2)

    (bat, (m1, m2)) = simulate()
    checked = b.check(index, tidx, m1, m2)
    # the set-up metric goes out once the check has passed
    b.emit(name, setup_s, "s", **extra)
    t0 = time.time()
    bs = backend.finish_batch_fast(
        backend.submit_pe(*fastq_pair(*bat), b.expected),
        backend.accumulator())
    log(f"warmup {time.time() - t0:.1f}s; mapped {bs.num_mapped}/"
        f"{args.batch}")

    n_batches = max(args.reads // args.batch, 1)
    acc = backend.accumulator()
    launches0 = trace.counter("launch.mmp_scan")
    mapped = total = 0
    map_time = 0.0
    batch_ms = []
    nxt, _ = simulate()
    for i in range(n_batches):
        bat = nxt
        t0 = time.perf_counter()
        tok = backend.submit_pe(*fastq_pair(*bat), b.expected)
        t_sub = time.perf_counter() - t0
        if i + 1 < n_batches:
            nxt, _ = simulate()
        t0 = time.perf_counter()
        bs = backend.finish_batch_fast(tok, acc)
        if i + 1 == n_batches:
            synchronize(b.dev)
        t_fin = time.perf_counter() - t0
        map_time += t_sub + t_fin
        batch_ms.append(1e3 * (t_sub + t_fin))
        mapped += bs.num_mapped
        total += bs.n
        log(f"  batch {i + 1}/{n_batches}: {batch_ms[-1]:.1f} ms, "
            f"{total / max(map_time, 1e-9):,.0f} frags/s, {len(acc)} "
            "classes")
    launches = trace.counter("launch.mmp_scan") - launches0
    pct = 100 * mapped / max(total, 1)
    log(f"mapped {mapped}/{total} ({pct:.1f}%) in {map_time:.3f}s; "
        f"{len(acc)} eq classes; scan kernel launches {launches}")
    b.emit("gencode_reads_per_sec", total / max(map_time, 1e-9), "frags/s",
           mapped_pct=round(pct, 2), eq_classes=len(acc), reads=total,
           seconds=map_time, batch_ms=[round(x, 3) for x in batch_ms],
           scan_launches=launches, checked=checked)
    if args.breakdown:
        stage_breakdown(index, tidx, [simulate()[1] for _ in range(2)],
                        b.card)

    eq, em, em_dt = b.em(index, acc, mapped, max_iter=1000)
    log(f"EM: {em.num_iterations} iters in {em_dt:.3f}s")
    b.emit("gencode_em_iters_per_sec", em.num_iterations / max(em_dt, 1e-9),
           "iters/s", iterations=int(em.num_iterations),
           eq_classes=eq.num_classes, seconds=em_dt)

    # posterior samplers at scale (BASELINE config 3)
    eff = effective_lengths(index)
    if args.bootstraps:
        from .infer.bootstrap import run_bootstraps

        synchronize(b.dev)
        t0 = time.time()
        n_done = sum(1 for _ in run_bootstraps(
            eq, eff, index.num_transcripts, device=b.dev,
            num_bootstraps=args.bootstraps, dtype=torch.float32))
        dt = time.time() - t0
        b.emit("gencode_bootstraps_per_sec", n_done / max(dt, 1e-9),
               "replicates/s", replicates=n_done, eq_classes=eq.num_classes,
               seconds=dt)
    if args.gibbs:
        from .infer.gibbs import run_gibbs

        synchronize(b.dev)
        t0 = time.time()
        n_done = sum(1 for _ in run_gibbs(
            eq, eff, em.alphas, index.num_transcripts, device=b.dev,
            num_samples=args.gibbs, total_mapped=float(mapped)))
        dt = time.time() - t0
        b.emit("gencode_gibbs_samples_per_sec", n_done / max(dt, 1e-9),
               "samples/s", samples=n_done, eq_classes=eq.num_classes,
               seconds=dt)


def add_world_flags(ap):
    """The flags that size a world and say where its index is: --txps,
    --bases, --index-dir and --cache (the gencode world's in
    capacity_envelope.py too).  Unset sizes are None."""
    ap.add_argument("--txps", type=int, help="transcripts (20,000 uniform; "
                    "200,000 at most gencode)")
    ap.add_argument("--bases", type=float,
                    help="gencode: transcriptome bases at most (150e6)")
    ap.add_argument("--index-dir",
                    help="gencode: an existing k = 31 index of this world")
    ap.add_argument("--cache", default=DEFAULT_CACHE,
                    help="directory of the cached indexes ('' for none)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="sailfish_tpu_torch.bench",
        description="mapping, EM and sampler throughput of the port on "
                    "a synthetic world (bench.py, tools/bench_gencode.py)")
    ap.add_argument("--world", choices=sorted(WORLD_FLAGS), default="uniform")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; fails without a card) or cpu, "
                    "where the kernels' plain versions run")
    ap.add_argument("--seed", type=int,
                    help="numpy seed of the world and reads (uniform, 0) "
                    "or of the reads (gencode, 11; its world is seed 7)")
    add_world_flags(ap)
    ap.add_argument("--txp-len", type=int,
                    help="uniform: base transcript length (1,000)")
    ap.add_argument("--read-len", type=int, help="uniform: mate length (100)")
    ap.add_argument("--err", type=float,
                    help="uniform: substitution rate (0.005)")
    ap.add_argument("--batches", type=int,
                    help="uniform: pre-simulated batches (12)")
    ap.add_argument("--reads", type=int,
                    help="gencode: fragments mapped, in whole batches (10M)")
    ap.add_argument("--bootstraps", type=int,
                    help="gencode: bootstrap replicates (0: none)")
    ap.add_argument("--gibbs", type=int,
                    help="gencode: Gibbs samples (0: none)")
    ap.add_argument("--batch", type=int, default=65536,
                    help="fragments a batch")
    ap.add_argument("--hitCapacity", type=int, default=64)
    ap.add_argument("--hitCapacityMax", type=int, default=1024)
    ap.add_argument("--check", type=int, default=2048,
                    help="fragments of the first batch held against the "
                    "reference mapper before any metric (0: none)")
    ap.add_argument("--breakdown", action="store_true",
                    help="per-batch stage breakdown and a profiled pass, "
                    "after the timed loop")
    ap.add_argument("--build-only", action="store_true",
                    help="build and cache the world's index, then exit")
    args = ap.parse_args(argv)
    given = {k for k, v in vars(args).items() if v is not None}
    for world, flags in WORLD_FLAGS.items():
        if world != args.world:
            other = given & (set(flags) - set(WORLD_FLAGS[args.world]))
            if other:
                ap.error(f"--world {args.world} takes no "
                         f"{', '.join(sorted(other))}")
    for k, v in WORLD_FLAGS[args.world].items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        b = Bench(args)
        (run_uniform if args.world == "uniform" else run_gencode)(b)
    except CheckFailure as e:
        log(f"bench: FAILED: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
