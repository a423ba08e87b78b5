#!/usr/bin/env python3
"""On-card smoke run of the torch port (sailfish_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # the full-size run, one card

Phases (each prints its lines; any failure exits non-zero before the
result line):
  1. toolchain: card, power limit, nvcc, triton, kernel build time
  2. world: a gene-family transcriptome (isoforms share exons; ~200k
     transcripts, ~150 Mb, numpy seed 7 — the GENCODE-scale world of
     tools/bench_gencode.py) written as FASTA and indexed with
     `python -m sailfish_tpu_torch.cli index -k 31` into .smoke_cache/
     (reused when present); 4 batches of 65,536 paired 100 bp fragments
     with 0.5% substitutions (seed 11) written as FASTQ
  3. kernel vs plain: the CUDA scan and its plain torch version on the
     same card tensors (8,192 fragments, both mates, fwd + rc lanes, an
     N in every 7th read) at C = 64 and C = 1024 (the main and the
     escalation pass) and at C = 2, where lanes must overflow; equal
     after the post-pass; both timed
  4. oracle: eq-class labels and counts of the first 2,048 fragments
     from the port's device backend equal its `--backend refimpl`
     backend (the numpy reference mapper), at --hitCapacity 64 and at
     --hitCapacity 2, where fragments take the escalation pass
  5. stages: per-batch ms of host pack + copy, device work and host fold
     at the main path's batch size (a synchronize closes each stage),
     then the same batches pipelined as quant runs them under
     torch.profiler: device busy and idle share, top kernels
  6. end to end: the port's `quant -l IU --hitCapacity 64
     --hitCapacityMax 1024 --dumpEq` through its CLI entry point, with
     the kernel launch counter reset before and read after; outputs
     checked (TPM sums to 1e6); EM rerun on the CPU must agree
  7. the kernel table line, the nvidia-smi line, then the result line

It imports only the port (sailfish_tpu_torch), no jax, and needs the
repository beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".smoke_cache")
READ_LEN = 100
ERR = 0.005
KERNEL_SRC = "sailfish_tpu_torch/csrc/mmp_scan.cu"
TPU_KERNEL = "sailfish_tpu/map/pallas_kernel.py:133"
T0 = time.time()


class SmokeFailure(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def note(*a):
    print(f"[{time.time() - T0:7.1f}s]", *a, file=sys.stderr, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- world
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


def simulate_batch(rng, concat, offs, lens, n):
    """n fragments: transcript uniform, length ~N(250, 25) clipped to
    [110, 600] and to the transcript, mate 2 reverse-complemented,
    substitutions at rate ERR (tools/bench_gencode.py simulate_batch)."""
    t = rng.integers(0, len(lens), n)
    fl = np.clip(rng.normal(250, 25, n).astype(np.int64), READ_LEN + 10, 600)
    fl = np.minimum(fl, lens[t])
    p = (rng.random(n) * (lens[t] - fl + 1)).astype(np.int64)
    start = offs[t] + p
    m1 = concat[start[:, None] + np.arange(READ_LEN)]
    i2 = start[:, None] + (fl[:, None] - READ_LEN) + np.arange(READ_LEN)
    m2 = (3 - concat[i2][:, ::-1]).astype(np.uint8)
    for m in (m1, m2):
        mask = rng.random(m.shape) < ERR
        m[mask] = (m[mask] + rng.integers(1, 4, mask.sum())) % 4
    return m1, m2


_ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_fasta(path, names, seqs):
    with open(path + ".tmp", "wb") as fh:
        for name, s in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n" + _ACGT[s].tobytes()
                     + b"\n")
    os.replace(path + ".tmp", path)


def write_fastq(path, reads):
    qual = b"I" * reads.shape[1]
    seqs = _ACGT[reads]
    with open(path, "wb") as fh:
        for i in range(reads.shape[0]):
            fh.write(b"@f%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))


# ---------------------------------------------------------------- phases
def phase_toolchain(torch):
    from sailfish_tpu_torch import _ext

    name = torch.cuda.get_device_name(0)
    say(f"device: {name} | count={torch.cuda.device_count()} | torch "
        f"{torch.__version__} (CUDA {torch.version.cuda})")
    say(f"nvidia-smi: {nvidia_smi_line()}")
    say(f"nvcc: {_ext.nvcc_version()} | ninja: "
        f"{'yes' if shutil.which('ninja') else 'no'}")
    try:
        import triton
        say(f"triton: imports ({triton.__version__})")
    except ImportError as e:
        say(f"triton: does not import ({e})")
    t0 = time.time()
    kl = _ext.load()
    regs = [ln.strip() for ln in kl.build_log.splitlines()
            if "registers" in ln]
    say(f"kernel build: {kl.build_seconds:.2f}s nvcc "
        f"({time.time() - t0:.2f}s with load) -> {kl.path.name}; "
        f"ptxas: {regs[0] if regs else 'n/a'}")
    return name


def phase_world(args, cli):
    from sailfish_tpu_torch.host import native_sais_available

    t0 = time.time()
    names, seqs = build_transcriptome(np.random.default_rng(7), args.txps,
                                      args.bases)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    concat = np.concatenate(seqs)
    say(f"world: {len(seqs)} transcripts, {lens.sum() / 1e6:.1f} Mb "
        f"(generated in {time.time() - t0:.1f}s)")
    key = f"{args.txps}_{int(args.bases)}"
    wdir = os.path.join(CACHE, key)
    os.makedirs(wdir, exist_ok=True)
    fasta = os.path.join(wdir, "transcripts.fa")
    idx_dir = os.path.join(wdir, "index")
    if not os.path.exists(fasta):
        write_fasta(fasta, names, seqs)
    native = native_sais_available()
    t0 = time.time()
    fresh = not os.path.exists(os.path.join(idx_dir, "header.json"))
    require(cli.main(["index", "-t", fasta, "-o", idx_dir, "-k", "31"]) == 0,
            "index build failed")
    say(f"index: {'built' if fresh else 'reused'} in "
        f"{time.time() - t0:.1f}s | native SA-IS: "
        f"{'used' if native else 'not available (numpy fallback)'}")
    rng = np.random.default_rng(11)
    batches = [simulate_batch(rng, concat, offs[:-1], lens, args.batch)
               for _ in range(args.batches)]
    return idx_dir, wdir, batches


def _padded(m):
    """(n, READ_LEN) codes -> (n, L) padded with code 4, L a multiple
    of 8 (the FASTQ reader's batch layout)."""
    L = (READ_LEN + 7) // 8 * 8
    codes = np.full((m.shape[0], L), 4, np.uint8)
    codes[:, :READ_LEN] = m
    return codes


def _fastq_batch(m):
    from sailfish_tpu_torch.host import FastqBatch

    return FastqBatch(_padded(m), np.full(m.shape[0], READ_LEN, np.int32))


def _lanes_for(torch, c1, c2, dev):
    """Both mates of the fragments as one lane block, with an N (code 4)
    at base 37 of every 7th read: an N hashes as A in the probe key but
    ends a match in the LCP, so these lanes hold the kernel to both."""
    from sailfish_tpu_torch.map.encode import make_oriented_lanes

    codes = np.concatenate([_padded(c1), _padded(c2)])
    codes[::7, 37] = 4
    lens = np.full(codes.shape[0], READ_LEN, np.int32)
    return make_oriented_lanes(torch.from_numpy(codes).to(dev),
                               torch.from_numpy(lens).to(dev)), codes.shape[1]


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernel_vs_plain(torch, tidx, batch, n_frags, card):
    from sailfish_tpu_torch.map.postpass import intersect_sort
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda, mmp_scan_reference

    dev = tidx.device
    c1, c2 = batch[0][:n_frags], batch[1][:n_frags]
    lanes, L = _lanes_for(torch, c1, c2, dev)
    n_lanes = lanes["codes"].shape[0]
    # lanes whose read holds an N: rows of every 7th read, fwd and rc
    has_n = (lanes["codes"] == 4).logical_and(
        torch.arange(L, device=dev)[None, :] < lanes["lens"][:, None]
    ).any(1)
    out = {}
    # 64: the main pass; 1024: the escalation pass; 2: a capacity that
    # the gene families overflow, so the kernel's cnt > C branch is held
    # against the plain version too
    for C in (64, 1024, 2):
        kw = dict(cand_cap=C, max_mmps=4, max_steps=L)
        k = mmp_scan_cuda(lanes, tidx, **kw)
        p = mmp_scan_reference(lanes, tidx, **kw)
        torch.cuda.synchronize()
        ks = intersect_sort(*k[:3], k[3][:, 0], C=C, M=4)
        ps = intersect_sort(*p[:3], p[3][:, 0], C=C, M=4)
        err = 0
        require(torch.equal(ks[2], ps[2]), f"C={C}: valid masks differ")
        v = ps[2]
        for a, b in ((ks[0][v], ps[0][v]), (ks[1][v], ps[1][v]),
                     (k[3][:, 1:3], p[3][:, 1:3]),
                     (ks[2].sum(1), ps[2].sum(1))):
            if a.numel():
                err = max(err, int((a.long() - b.long()).abs().max()))
        require(err == 0, f"C={C}: kernel and plain version differ "
                f"(max abs err {err})")
        raw_equal = all(torch.equal(x, y) for x, y in zip(k, p))
        ms = _time_ms(torch, lambda: mmp_scan_cuda(lanes, tidx, **kw), 5)
        plain_ms = _time_ms(
            torch, lambda: mmp_scan_reference(lanes, tidx, **kw), 1)
        over = k[3][:, 1] != 0
        nover, nover_n = int(over.sum()), int((over & has_n).sum())
        if C == 2:
            require(nover > 0, "C=2: no lane overflowed")
        say(f"kernel vs plain C={C}: {n_lanes} lanes ({n_frags} fragments "
            f"x 2 mates x fwd/rc; {int(has_n.sum())} lanes with an N), "
            f"equal after the post-pass (raw slots equal: {raw_equal}); "
            f"overflow lanes {nover} ({nover_n} with an N), mapped lanes "
            f"{int((v.sum(1) > 0).sum())}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms [{card}]")
        out[C] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    return out


def phase_oracle(torch, index, tidx, batch, n_frags):
    from sailfish_tpu_torch.host import QuantOpts, parse_library_format
    from sailfish_tpu_torch.map.pipeline import (
        DeviceMapperBackend,
        RefMapperBackend,
    )

    exp = parse_library_format("IU")
    b1, b2 = (_fastq_batch(m[:n_frags]) for m in batch)
    # C = 64 is the main pass; C = 2 overflows every multi-isoform seed
    # and sends those fragments through the escalation pass at 1024 —
    # both must give the oracle's classes (its envelope is 1024 either way)
    ports = {}
    for cap in (64, 2):
        opts = QuantOpts(hit_capacity=cap, hit_capacity_max=1024)
        port = DeviceMapperBackend(index, opts, tidx.device, tindex=tidx)
        t0 = time.time()
        tok = port.submit_pe(b1, b2, exp)
        escalated = int(tok[0]["scalars"][72])
        br = port.finish_batch(tok)
        ports[cap] = (br, escalated, time.time() - t0)
    t0 = time.time()
    oracle = RefMapperBackend(index, QuantOpts(hit_capacity=64,
                                               hit_capacity_max=1024))
    ref_br = oracle.map_pe_batch(b1, b2, exp)
    ref = dict(zip(ref_br.labels, ref_br.label_counts.tolist()))
    t_ref = time.time() - t0
    for cap, (br, escalated, t_port) in ports.items():
        got = dict(zip(br.labels, br.label_counts.tolist()))
        require(got == ref, f"--hitCapacity {cap}: eq classes differ from "
                f"the oracle: {len(set(got.items()) ^ set(ref.items()))} "
                "(label, count) pairs")
        require(np.array_equal(br.mapped, ref_br.mapped),
                f"--hitCapacity {cap}: mapped flags differ")
        say(f"oracle: {n_frags} fragments at --hitCapacity {cap} "
            f"--hitCapacityMax 1024 ({escalated} escalated): {len(ref)} eq "
            f"classes, {int(ref_br.mapped.sum())} mapped, identical to the "
            f"refimpl backend (port {t_port:.2f}s, oracle {t_ref:.1f}s)")
    require(ports[2][1] > 0, "the C = 2 pass escalated no fragment")


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def phase_stages(torch, index, tidx, batches, card):
    """Where a batch's time goes at the main path's batch size.  Pass 1
    closes each stage with a synchronize; pass 2 runs the batches as
    quant does (one-deep pipeline, no extra syncs) under torch.profiler,
    which gives the device's busy time against the wall time."""
    from sailfish_tpu_torch.host import QuantOpts, parse_library_format
    from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend

    exp = parse_library_format("IU")
    dev = tidx.device
    be = DeviceMapperBackend(index, QuantOpts(hit_capacity=64,
                                              hit_capacity_max=1024),
                             dev, tindex=tidx)
    fq = [tuple(_fastq_batch(m) for m in b) for b in batches]

    def sync():
        torch.cuda.synchronize(dev)

    names = ("prefetch_pe (host pack + copy)",
             "map_prefetched (lanes, scan, post-pass, merge/collapse)",
             "finish_batch_fast (host eq-class fold)")
    ms = {n: [] for n in names}
    acc = be.accumulator()
    for b1, b2 in fq:
        sync()
        t = [time.perf_counter()]
        pf = be.prefetch_pe(b1, b2)
        sync()
        t.append(time.perf_counter())
        tok = be.map_prefetched(pf, exp)
        sync()
        t.append(time.perf_counter())
        be.finish_batch_fast(tok, acc)
        t.append(time.perf_counter())
        for n, a, b in zip(names, t, t[1:]):
            ms[n].append(1e3 * (b - a))
    steady = slice(1, None) if len(fq) > 1 else slice(None)
    for n in names:
        say(f"stage {n}: median {np.median(ms[n][steady]):.3f} ms over "
            f"batches 2..{len(fq)} (all: "
            f"{', '.join(f'{x:.3f}' for x in ms[n])}) "
            f"[{fq[0][0].count} fragments/batch, {card}]")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acc = be.accumulator()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pending = None
        for b1, b2 in fq:
            tok = be.submit_pe(b1, b2, exp)
            if pending is not None:
                be.finish_batch_fast(pending, acc)
            pending = tok
        be.finish_batch_fast(pending, acc)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies, fills): an operator's
    # own entry repeats the time of the kernels it launched
    evts = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and _device_us(e) > 0), key=_device_us, reverse=True)
    busy_us = sum(_device_us(e) for e in evts)
    if not evts:
        say("profile: not measured (torch.profiler recorded no device "
            "time)")
        return
    scan_us = sum(_device_us(e) for e in evts if "mmp_scan" in e.key)
    say(f"profile: {len(fq)} batches pipelined as quant runs them: wall "
        f"{wall_us / 1e3:.3f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%); scan kernel "
        f"{scan_us / 1e3:.3f} ms ({100 * scan_us / busy_us:.1f}% of busy) "
        f"[{card}]")
    for e in evts[:8]:
        say(f"profile kernel: {_device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_end_to_end(torch, cli, wdir, idx_dir, batches, batch, card):
    from sailfish_tpu_torch.host import read_eq_classes
    from sailfish_tpu_torch.infer.em import run_em
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda

    r1 = os.path.join(wdir, "reads_1.fq")
    r2 = os.path.join(wdir, "reads_2.fq")
    write_fastq(r1, np.concatenate([b[0] for b in batches]))
    write_fastq(r2, np.concatenate([b[1] for b in batches]))
    n = sum(b[0].shape[0] for b in batches)
    out = os.path.join(wdir, "quant")
    shutil.rmtree(out, ignore_errors=True)
    mmp_scan_cuda.launches = 0
    t0 = time.time()
    rc = cli.main(["quant", "-i", idx_dir, "-l", "IU", "-1", r1, "-2", r2,
                   "-o", out, "--hitCapacity", "64", "--hitCapacityMax",
                   "1024", "--dumpEq", "--batchSize", str(batch)])
    wall = time.time() - t0
    launches = mmp_scan_cuda.launches
    require(rc == 0, f"quant exited {rc}")
    require(launches > 0, "the main path launched the scan kernel 0 times")

    with open(os.path.join(out, "aux", "meta_info.json")) as fh:
        meta = json.load(fh)
    qt = meta["quant_timings"]
    require(qt["device"].startswith("cuda"), f"quant ran on {qt['device']}")
    with open(os.path.join(out, "quant.sf")) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh][1:]
    vals = np.array([[float(x) for x in r[1:]] for r in rows])
    require(len(rows) > 0 and np.isfinite(vals).all(), "quant.sf malformed")
    tpm = vals[:, 2].sum()
    require(abs(tpm - 1e6) <= 1.0, f"TPM sums to {tpm}")
    require(abs(vals[:, 3].sum() - meta["num_mapped"])
            <= 1e-3 * meta["num_mapped"] + 1, "NumReads != mapped")
    eq_path = os.path.join(out, "aux", "eq_classes.txt")
    require(os.path.exists(eq_path), "aux/eq_classes.txt missing")
    _, eq = read_eq_classes(eq_path)
    bms = qt["batch_ms"]
    steady = (f"{batch * (len(bms) - 1) / (sum(bms[1:]) / 1e3):.0f} reads/s "
              "after the first batch" if len(bms) > 1 else "one batch")
    say(f"quant: {n} fragments in {len(bms)} batches, mapping rate "
        f"{100.0 * meta['num_mapped'] / meta['num_processed']:.2f}%, "
        f"{eq.num_classes} eq classes, {qt['escalated_fragments']} "
        f"fragments escalated to C=1024, kernel launches {launches}, "
        f"TPM sum {tpm:.3f}, CLI wall {wall:.1f}s [{card}]")
    say(f"quant batches: ms {bms} | {n / qt['mapping_seconds']:.0f} "
        f"reads/s over the mapping loop, {steady} [{card}]")
    say(f"quant EM: {qt['em_iterations']} iterations in "
        f"{qt['inference_seconds']:.3f}s "
        f"({qt['em_iterations'] / max(qt['inference_seconds'], 1e-9):.1f} "
        f"iterations/s, float64) [{card}]")

    # the EM on the card against the same EM on the CPU (torch)
    eff = vals[:, 1]
    total = float(meta["num_mapped"])
    t0 = time.time()
    g = run_em(eq, eff, total, len(rows), device="cuda")
    t_g = time.time() - t0
    t0 = time.time()
    c = run_em(eq, eff, total, len(rows), device="cpu")
    t_c = time.time() - t0
    require(g.num_iterations == c.num_iterations,
            f"EM iterations differ: cuda {g.num_iterations}, cpu "
            f"{c.num_iterations}")
    require(np.allclose(g.alphas, c.alphas, rtol=1e-6, atol=1e-8),
            "EM alphas differ between cuda and cpu beyond rtol 1e-6")
    rel = np.abs(g.alphas - c.alphas) / np.maximum(np.abs(c.alphas), 1e-300)
    say(f"EM cuda vs cpu: {g.num_iterations} iterations both, max rel "
        f"diff {float(rel[c.alphas > 0].max(initial=0.0)):.3g} "
        f"(cuda {t_g:.2f}s, cpu {t_c:.2f}s) [{card}]")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--bases", type=float, default=150e6)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--kernel-frags", type=int, default=8192)
    ap.add_argument("--oracle-frags", type=int, default=2048)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from sailfish_tpu_torch import cli
        from sailfish_tpu_torch.host import load_index
        from sailfish_tpu_torch.index.device import TorchIndex
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    try:
        card = phase_toolchain(torch)
        smi = nvidia_smi_line()
        idx_dir, wdir, batches = phase_world(args, cli)
        note("world ready")
        t0 = time.time()
        index = load_index(idx_dir)
        tidx = TorchIndex.from_quasi_index(index, "cuda")
        say(f"index on card: {tidx.n_text} text positions, 2^"
            f"{tidx.ht_bits} k-mer buckets, probe chain <= "
            f"{tidx.ht_probes} (load + upload {time.time() - t0:.1f}s)")
        kv = phase_kernel_vs_plain(torch, tidx, batches[0],
                                   args.kernel_frags, smi)
        note("kernel vs plain done")
        phase_oracle(torch, index, tidx, batches[0], args.oracle_frags)
        note("oracle done")
        phase_stages(torch, index, tidx, batches, smi)
        note("stages done")
        del tidx, index
        torch.cuda.empty_cache()
        launches = phase_end_to_end(torch, cli, wdir, idx_dir, batches,
                                    args.batch, smi)
        note("end to end done")
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [{
        "name": "mmp_scan", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in kv.values()),
        "ms": kv[64]["ms"], "plain_ms": kv[64]["plain_ms"],
        "ms_c1024": kv[1024]["ms"], "plain_ms_c1024": kv[1024]["plain_ms"],
        "ms_c2": kv[2]["ms"], "plain_ms_c2": kv[2]["plain_ms"],
    }]
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
