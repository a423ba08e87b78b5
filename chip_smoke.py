#!/usr/bin/env python3
"""On-card smoke run of the torch port (sailfish_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # the full-size run, one card

Phases (each prints its lines; any failure exits non-zero before the
result line):
  1. toolchain: card, power limit, nvcc, triton, the build of both CUDA
     kernels (csrc/mmp_scan.cu, csrc/ubench.cu) and of the native host
     helpers (g++), the card's copy bandwidth
  2. ubench: each of the 17 op-chain variants of csrc/ubench.cu against
     its plain version at 2,048 iterations from seeded buffers (exact
     int32 equality), then `python -m sailfish_tpu_torch.ubench --iters
     100000` through its entry point: ns per iteration of each variant;
     `empty` must be the fastest
  3. world: a gene-family transcriptome (isoforms share exons; ~200k
     transcripts, ~150 Mb, numpy seed 7 — the GENCODE-scale world of
     tools/bench_gencode.py) written as FASTA and indexed with
     `python -m sailfish_tpu_torch.cli index -k 31` into .smoke_cache/
     (reused when present; the native SA-IS is required at this scale);
     2 batches of 65,536 paired 100 bp fragments with 0.5% substitutions
     (seed 11) and 1 batch of 65,536 paired 152 bp fragments (seed 13)
     written as FASTQ
  4. kernel vs plain: the CUDA scan, run into buffers filled with 0xFF,
     and its plain torch version on the same card tensors: all four
     outputs equal bit for bit (every slot written), equal after the
     post-pass, both timed, with the least time the card could take for
     the same bytes and operations, and the table rows the kernel read
     beside those the scan needs.
     First the three lane blocks that the runs of phase 7 give the
     kernel, whole and unchanged, at C = 64: a batch of 65,536 paired
     100 bp fragments (both mates, fwd + rc: 262,144 lanes, L = 104),
     its first mates as a single-end batch (131,072 lanes) and a batch
     of paired 152 bp fragments (262,144 lanes, L = 152).  Then a
     sample of 8,192 fragments with an N in every 7th read: C = 64,
     C = 64 under the jump rule, C = 1024 (the escalation pass) and
     C = 2, where lanes must overflow, at L = 104, and C = 64 at L = 152
     and L = 304.  Last the risk reads (ragged lengths, the text's tail,
     Ns on k-mer edges, miss chains that cross a probe window) at step
     budgets of 1, 31, 32, 33 and L, under both skip rules, at C = 64
     and C = 2
  5. oracle: eq-class labels and counts of a sample of fragments from
     the port's device backend equal its `--backend refimpl` backend
     (the numpy reference mapper): paired 100 bp at --hitCapacity 64 and
     at --hitCapacity 2, where fragments take the escalation pass;
     single-end 100 bp reads (-l U); paired 152 bp
  6. stages: per-batch ms of host pack + copy, device work and host fold
     at the main path's batch size (a synchronize closes each stage),
     then the same batches pipelined as quant runs them under
     torch.profiler: device busy and idle share, top kernels
  7. end to end, each through the CLI entry point with the kernels'
     launch counters reset before and read after, outputs checked (TPM
     sums to 1e6, the run was on cuda): `quant -l IU --hitCapacity 64
     --hitCapacityMax 1024 --dumpEq` on the paired 100 bp reads (EM
     rerun on the CPU must agree), `quant -l U -r` on their first mates
     as a single-end library, and `quant -l IU` on the paired 152 bp
     reads
  8. bias: on the oracle sample of phase 5, the device backend's bias
     observations (6-mer samples with --biasCorrect, the GC histogram
     with --gcBiasCorrect) equal the refimpl backend's per-hit replay,
     integer for integer; the ms they add to a batch's device work;
     then `quant -l IU --biasCorrect` and `quant -l IU --gcBiasCorrect`
     on the paired 100 bp library through the CLI (effective lengths
     finite and positive, `update_effective_lengths` ran, the observed
     files add up); then `update_effective_lengths` on the card against
     the same function on the CPU on the world's first transcripts,
     rtol 1e-9
  9. resume and samplers, from the eq-class dump of phase 7's paired
     run, so that nothing is mapped twice: `--resumeFromEq` alone
     (quant.sf equal to the dumping run's), with `--numBootstraps 16`,
     with `--numBootstraps 16 --useVBOpt` and with `--numGibbsSamples
     16`: replicates of the right type and length, Gibbs samples that
     sum to the mapped count exactly, replicate means near the point
     estimate
 10. two libraries in one run (`-l IU -1 .. -2 .. -l U -r ..`): the
     fragments and classes of the two single-library runs of phase 7
     added up; and `--checkpointInterval` on the paired run: a
     checkpoint after each batch, the final classes unchanged
 11. the kernel table line, the nvidia-smi line, then the result line

`--kernel-only` runs phases 1, 3 and 4 (toolchain, world, kernel vs
plain) and prints no result line: the quick way to time a change to the
scan kernel.

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
LONG_READ_LEN = 152
KERNEL_SRC = "sailfish_tpu_torch/csrc/mmp_scan.cu"
TPU_KERNEL = "sailfish_tpu/map/pallas_kernel.py:133"
UBENCH_SRC = "sailfish_tpu_torch/csrc/ubench.cu"
UBENCH_TPU_KERNEL = "tools/ubench_pallas.py:37"
UBENCH_CHECK_ITERS = 2048
UBENCH_ITERS = 100_000
# published peaks of one H100 SXM: HBM bytes/s, and float32 operations/s
# outside the tensor cores (the rate taken for the kernels' integer work)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
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


def simulate_batch(rng, concat, offs, lens, n, read_len=READ_LEN):
    """n fragments: transcript uniform, length ~N(250, 25) clipped to
    [read_len + 10, 600] and to the transcript, mate 2
    reverse-complemented, substitutions at rate ERR
    (tools/bench_gencode.py simulate_batch)."""
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
    from sailfish_tpu_torch.io.native import native_sais_available

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
    require(kl.lib.sf_ubench_num_variants() == 17,
            "csrc/ubench.cu does not hold 17 variants")
    regs = [int(ln.split("Used ")[1].split()[0])
            for ln in kl.build_log.splitlines() if "Used " in ln]
    spills = [ln for ln in kl.build_log.splitlines()
              if "spill stores" in ln and "0 bytes spill stores" not in ln]
    say(f"kernel build: {len(_ext.SOURCES)} sources, {kl.build_seconds:.2f}s "
        f"nvcc in parallel ({time.time() - t0:.2f}s with load) -> "
        f"{kl.path.name}; ptxas: {len(regs)} kernels, registers "
        f"{min(regs, default=0)}-{max(regs, default=0)}, "
        f"{len(spills)} with spills")
    lines = kl.build_log.splitlines()
    for n, ln in enumerate(lines):
        if "Compiling entry function" in ln and "mmp_scan_kernel" in ln:
            say("ptxas mmp_scan_kernel: " + " | ".join(
                x.replace("ptxas info    :", "").strip()
                for x in lines[n + 1:n + 4]))
    t0 = time.time()
    native = native_sais_available()
    say(f"host helpers (g++): {'built and loaded' if native else 'NOT built'}"
        f" in {time.time() - t0:.2f}s")
    return name


def phase_copy_bandwidth(torch, card) -> float:
    """Device-to-device copy of 1 GiB, bytes read plus bytes written per
    second: the memory rate this card reaches, beside the published
    peak that the bounds use."""
    src = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = _time_ms(torch, lambda: dst.copy_(src), 10)
    rate = 2 * src.numel() / (ms / 1e3)
    say(f"copy bandwidth: {rate / 1e12:.3f} TB/s (1 GiB device-to-device "
        f"copy, {ms:.3f} ms; published peak {PEAK_BYTES_S / 1e12:.2f} TB/s) "
        f"[{card}]")
    return rate


# Work of each ubench variant, for the bound: the small buffers it reads
# (once each, whatever the iteration count), the bytes one iteration
# asks of each large buffer, and the operations of one iteration,
# counted by hand from the chain as ubench.py's docstring writes it.
# "walk" stands for the text bytes the 32 threads compare, which depend
# on the data (see ubench_bound).
_UBENCH_WORK = {
    "empty": ((), {}, 1),
    "roll16x4": (("tile",), {}, 96),
    "roll1x4": (("pair",), {}, 6),
    "store6": (("tile", "pair"), {}, 14),
    "alignchain": (("read",), {"sa": 32 * 4, "text": "walk"}, 12),
    "lcp": (("al",), {}, 40),
    "when8_true": ((), {}, 17),
    "when8_false": ((), {}, 9),
    "when8_smem": ((), {}, 25),
    "select8": ((), {}, 18),
    "while0": ((), {}, 3),
    "smem16": (("xs",), {}, 33),
    "dma16": ((), {"hbm": 16 * 128 * 4}, 20),
    "dma16x4": ((), {"hbm": 4 * 16 * 128 * 4}, 80),
    "bucket64": ((), {"table": 64}, 12),
    "sa_window": ((), {"sa": 64 * 4}, 16),
    "text_read": (("read",), {"text": "walk"}, 12),
}


def ubench_bound(variant, iters, result, bufs):
    """(bytes, operations) that `iters` iterations of a variant from
    acc = 0 must move and do.  A buffer's bytes count once however often
    the chain returns to them: a variant asks of a large buffer
    min(bytes per iteration * iters, the buffer's size).  A walk variant
    adds the longest walk plus one to the accumulator, so `result` is
    the bytes its longest-walking thread compared; each of the other 31
    threads compares at least one byte per iteration.  Operations per
    compared byte: 6, as in the scan's bound."""
    small, large, ops = _UBENCH_WORK[variant]
    size = {k: v.numel() * v.element_size() for k, v in bufs.items()}
    walk = result + 31 * iters
    nbytes = 4 + sum(size[k] for k in small)
    nops = ops * iters
    for name, per_iter in large.items():
        if per_iter == "walk":
            nbytes += min(walk, size[name])
            nops += 6 * walk
        else:
            nbytes += min(per_iter * iters, size[name])
    return nbytes, nops


def phase_ubench(torch, card):
    """The op-chain microbenchmark kernel against its plain version, then
    its entry point, which is that tool's main path."""
    import contextlib
    import io

    from sailfish_tpu_torch import ubench

    t0 = time.time()
    cpu = ubench.make_buffers(0)
    gpu = {k: v.cuda() for k, v in cpu.items()}
    say(f"ubench buffers: seed 0, "
        f"{sum(v.numel() * v.element_size() for v in cpu.values()) / 2**20:.0f}"
        f" MiB (table {cpu['table'].shape[0]} rows, suffix array "
        f"{cpu['sa'].numel()}, text {cpu['text'].numel()} bytes) in "
        f"{time.time() - t0:.1f}s")
    err, ms, plain_ms, nbytes, nops = 0, 0.0, 0.0, 0, 0
    for v in ubench.VARIANTS:
        t0 = time.perf_counter()
        want = ubench.ubench_reference(v, UBENCH_CHECK_ITERS, 0, cpu)
        plain_ms += 1e3 * (time.perf_counter() - t0)
        got = int(ubench.ubench_cuda(v, UBENCH_CHECK_ITERS, 0, gpu).item())
        err = max(err, abs(got - want))
        require(got == want, f"ubench {v}: kernel {got} != plain {want} "
                f"after {UBENCH_CHECK_ITERS} iterations")
        ms += ubench.time_variant(v, UBENCH_CHECK_ITERS, 0, gpu) \
            * UBENCH_CHECK_ITERS / 1e6
        b, o = ubench_bound(v, UBENCH_CHECK_ITERS, want, cpu)
        nbytes, nops = nbytes + b, nops + o
    bound = bound_ms(nbytes, nops)
    say(f"ubench kernel vs plain: all {len(ubench.VARIANTS)} variants "
        f"equal (exact int32) after {UBENCH_CHECK_ITERS} iterations; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms for the 17 together; "
        f"bound {bound['bound_ms']:.5f} ms by {bound['bound_by']} "
        f"({nbytes} bytes counted once per buffer, {nops} operations) "
        f"[{card}]")
    del gpu
    torch.cuda.empty_cache()

    # the tool's main path, through its entry point
    ubench.ubench_cuda.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ubench.main(["--iters", str(UBENCH_ITERS)])
    launches = ubench.ubench_cuda.launches
    require(rc == 0, f"ubench exited {rc}")
    ns = {}
    for ln in buf.getvalue().splitlines():
        if ln.endswith("ns/iter"):
            ns[ln.split()[0]] = float(ln.split()[1])
            say(f"ubench {ln} [{card}]")
    require(set(ns) == set(ubench.VARIANTS), "ubench printed "
            f"{sorted(ns)}, not the 17 variants")
    require(launches >= len(ubench.VARIANTS),
            f"the ubench entry point launched its kernel {launches} times")
    slow = [v for v in ubench.VARIANTS
            if v != "empty" and not ns[v] > 1.02 * ns["empty"]]
    require(not slow, f"ubench: {slow} take no longer than `empty` "
            f"({ns['empty']} ns/iter): a chain was folded away")
    return {"name": "ubench", "route": "cuda", "source": UBENCH_SRC,
            "replaces": UBENCH_TPU_KERNEL, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": None, "iters": UBENCH_CHECK_ITERS,
            "ns_per_iter_at_100000": ns}


def bound_ms(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    published memory rate and operations over the published rate."""
    tb, to = 1e3 * nbytes / PEAK_BYTES_S, 1e3 * nops / PEAK_OPS_S
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def phase_world(args, cli):
    from sailfish_tpu_torch.io.native import native_sais_available

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
        f"{time.time() - t0:.1f}s | suffix array: "
        f"{'native SA-IS' if native else 'numpy prefix doubling'}")
    require(native or lens.sum() < 50e6, "the native SA-IS did not build; "
            "the numpy fallback is too slow for a world of this size")
    rng = np.random.default_rng(11)
    batches = [simulate_batch(rng, concat, offs[:-1], lens, args.batch)
               for _ in range(args.batches)]
    long_batch = simulate_batch(np.random.default_rng(13), concat,
                                offs[:-1], lens, args.batch, LONG_READ_LEN)
    # reads of 304 bases for the kernel comparison: cut from the
    # concatenated text (most span a transcript boundary), with
    # substitutions; the second block reverse-complemented
    r304 = np.random.default_rng(17)
    starts = r304.integers(0, len(concat) - 304, (2, args.kernel_frags))
    xl = [concat[st[:, None] + np.arange(304)] for st in starts]
    for m in xl:
        mask = r304.random(m.shape) < ERR
        m[mask] = (m[mask] + r304.integers(1, 4, mask.sum())) % 4
    xl[1] = (3 - xl[1][:, ::-1]).astype(np.uint8)
    return idx_dir, wdir, batches, long_batch, tuple(xl), seqs


def risk_reads(seqs, k, L, seed):
    """Reads that a windowed, chunked scan can get wrong, cut from the
    transcripts `seqs` (uint8 code arrays in text order, each at least L
    bases): (codes (n, L) uint8 padded with code 4, lens (n,) int32).

      - ragged lengths: k - 1, k, L - 1, L and some between
      - reads that end on the last base of the last transcript, and reads
        that run past it (their match ends at the text's final separator)
      - an N at the first, the 16th and the last base of a k-mer, and at
        the read's last base
      - a read across two transcripts with an N where the text has its
        separator: an N ends a match even against a text code 4
      - a substitution every 33 bases, so that under 17 <= k <= 31 only
        a few k-mers per read are in the table and the miss chains
        between them cross a 32-position probe window
      - clean reads, which map on their first probe
    tests/torch_port.py carries this function too (the CPU tests' copy)."""
    rng = np.random.default_rng(seed)
    out = []

    def cut(n):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - n + 1))
        return s[p:p + n].copy()

    for n in (k - 1, k, k + 1, L - 1, L, (k + L) // 2):
        out += [cut(n) for _ in range(3)]
    last = seqs[-1]
    for n in (L, L - 1, k, k + 9):
        out.append(last[len(last) - n:].copy())
    for keep in (k, k + 5, L // 2):
        tail = rng.integers(0, 4, L - keep).astype(np.uint8)
        out.append(np.concatenate([last[len(last) - keep:], tail]))
    for p0 in (0, 7, L - k):
        for at in (p0, p0 + 15, p0 + k - 1):
            m = cut(L)
            m[at] = 4
            out.append(m)
    for n in (L, L - 3):
        m = cut(n)
        m[n - 1] = 4
        out.append(m)
    for t in (0, int(rng.integers(0, len(seqs) - 1))):
        m = np.concatenate([seqs[t][len(seqs[t]) - k - 9:], [4],
                            seqs[t + 1][:L - k - 10]]).astype(np.uint8)
        out.append(m)
    for first in (16, 0, 32):
        for _ in range(3):
            m = cut(L)
            m[first::33] = (m[first::33] + 1) % 4
            out.append(m)
    out += [cut(L) for _ in range(4)]
    codes = np.full((len(out), L), 4, np.uint8)
    for i, m in enumerate(out):
        codes[i, :len(m)] = m
    return codes, np.array([len(m) for m in out], np.int32)


def _padded(m):
    """(n, read_len) codes -> (n, L) padded with code 4, L a multiple
    of 8 (the FASTQ reader's batch layout)."""
    L = (m.shape[1] + 7) // 8 * 8
    codes = np.full((m.shape[0], L), 4, np.uint8)
    codes[:, :m.shape[1]] = m
    return codes


def _fastq_batch(m):
    from sailfish_tpu_torch.io.fastq import FastqBatch

    return FastqBatch(_padded(m), np.full(m.shape[0], m.shape[1], np.int32))


def _mate_reads(mates, with_n):
    """The mates of the fragments as one block of reads, as the backend
    lays it out (rows [m1; m2], or [m] for a single-end batch): (codes,
    lens, description).  `with_n` puts an N (code 4) at base 37 of every
    7th read: an N hashes as A in the probe key but ends a match in the
    LCP, so such lanes hold the kernel to both."""
    codes = np.concatenate([_padded(m) for m in mates])
    if with_n:
        codes[::7, 37] = 4
    lens = np.full(codes.shape[0], mates[0].shape[1], np.int32)
    return codes, lens, f"{mates[0].shape[0]} reads x {len(mates)} mates"


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


def scan_bound(lanes, meta, work, C, M):
    """Least time for one scan call on these inputs.  Bytes that must
    move: per lane L code bytes, 4 L packed-word bytes, its length and
    its 16 bytes of meta; 64 bytes per table row read; 4 bytes of suffix
    array and the compared text bytes per candidate; 8 bytes per stored
    candidate (its `txp_of_pos` and `txp_offsets` entries); and the M * C
    slots of 9 bytes per lane, each written once.  Operations: about
    40 per probed position, 10 per candidate, 6 per compared byte."""
    n, L = lanes["codes"].shape
    steps = int(meta[:, 3].sum())
    nbytes = (n * (5 * L + 4 + 16) + 64 * work["buckets"]
              + 4 * work["candidates"] + work["text_bytes"]
              + 8 * work["stored"] + n * M * C * 9)
    nops = 40 * steps + 10 * work["candidates"] + 6 * work["text_bytes"]
    return bound_ms(nbytes, nops)


def phase_kernel_vs_plain(torch, tidx, tag, reads, cases, card, copy_rate):
    """The CUDA scan against its plain version on the oriented lanes of
    `reads` ((codes, lens, description) on the host) in each of `cases`:
    dicts of `cand_cap` and, where they differ from the main path's,
    `max_steps` (default L) and `skip_jump`.  The kernel writes into
    buffers filled with 0xFF, so a slot it left out shows.
    Returns {"<tag>_L<L>_C<C>[_jump][_S<max_steps>]": readings}."""
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.postpass import intersect_sort
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda, mmp_scan_reference

    dev = tidx.device
    codes, lens, what = reads
    L = codes.shape[1]
    lanes = make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                torch.from_numpy(lens).to(dev))
    n_lanes = lanes["codes"].shape[0]
    # lanes whose read holds an N, fwd and rc
    has_n = (lanes["codes"] == 4).logical_and(
        torch.arange(L, device=dev)[None, :] < lanes["lens"][:, None]
    ).any(1)
    out = {}
    for case in cases:
        C = case["cand_cap"]
        kw = {"max_mmps": 4, "max_steps": L, "skip_jump": False, **case}
        name = (f"{tag}_L{L}_C{C}" + ("_jump" if kw["skip_jump"] else "")
                + (f"_S{kw['max_steps']}" if "max_steps" in case else ""))
        work = {}
        bufs = tuple(
            torch.full(shape, fill, dtype=dt, device=dev)
            for shape, fill, dt in (
                ((n_lanes, 4 * C), -1, torch.int32),
                ((n_lanes, 4 * C), -1, torch.int32),
                ((n_lanes, 4 * C), 255, torch.uint8),
                ((n_lanes, 4), -1, torch.int32)))
        k = mmp_scan_cuda(lanes, tidx, out=bufs, **kw)
        p = mmp_scan_reference(lanes, tidx, work=work, **kw)
        torch.cuda.synchronize()
        err = 0
        # valid as bytes: a slot still 0xFF must not pass for True
        for what_out, a, b in zip(("txp", "pos", "valid", "meta"), k, p):
            a = a.view(torch.uint8) if a.dtype == torch.bool else a
            d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            require(d == 0, f"{name}: raw `{what_out}` of the kernel "
                    f"differs from the plain version's in "
                    f"{int((a.long() != b.long()).sum())} places (max abs "
                    f"diff {d})")
            err = max(err, d)
        ks = intersect_sort(*k[:3], k[3][:, 0], C=C, M=4)
        ps = intersect_sort(*p[:3], p[3][:, 0], C=C, M=4)
        require(all(torch.equal(x, y) for x, y in zip(ks, ps)),
                f"{name}: kernel and plain version differ after the "
                "post-pass")
        mapped = int((ps[2].sum(1) > 0).sum())
        del ks, ps, p, bufs
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        mmp_scan_cuda(lanes, tidx, rows_read=rows, **kw)
        rows = int(rows.item())
        require(rows >= work["buckets"], f"{name}: the kernel read {rows} "
                f"table rows, fewer than the {work['buckets']} the scan "
                "needs")
        ms = _time_ms(torch, lambda: mmp_scan_cuda(lanes, tidx, **kw), 5)
        plain_ms = _time_ms(
            torch, lambda: mmp_scan_reference(lanes, tidx, **kw), 1)
        bound = scan_bound(lanes, k[3], work, C, 4)
        over = k[3][:, 1] != 0
        nover, nover_n = int(over.sum()), int((over & has_n).sum())
        if C == 2 and "max_steps" not in case:
            require(nover > 0, f"{name}: no lane overflowed")
        say(f"kernel vs plain {name}: {n_lanes} lanes ({what} x fwd/rc; "
            f"{int(has_n.sum())} lanes with an N), all four raw outputs "
            f"equal written over 0xFF, equal after the post-pass; overflow "
            f"lanes {nover} ({nover_n} with an N), mapped lanes {mapped}; "
            f"probed positions {int(k[3][:, 3].sum())}, table rows needed "
            f"{work['buckets']}, read by the kernel {rows} "
            f"({rows / max(work['buckets'], 1):.4f}x), candidates "
            f"{work['candidates']} ({work['stored']} stored), text "
            f"bytes {work['text_bytes']}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']} at the published peak "
            f"({bound['bound_ms'] * PEAK_BYTES_S / copy_rate:.4f} ms at "
            f"the measured copy rate), kernel / bound "
            f"{ms / bound['bound_ms']:.2f} [{card}]")
        out[name] = {
            "lanes": n_lanes, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err, "table_rows_needed": work["buckets"],
            "table_rows_read": rows, **bound}
        del k
        torch.cuda.empty_cache()
    return out


def phase_oracle(torch, index, tidx, mates, lib, caps):
    """Eq classes of a sample from the device backend against the
    refimpl backend.  `mates` is (m1, m2) for a paired library or (m,)
    for a single-end one; `caps` the --hitCapacity values to run."""
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import (
        DeviceMapperBackend,
        RefMapperBackend,
    )

    exp = parse_library_format(lib)
    bs = tuple(_fastq_batch(m) for m in mates)
    n, rl = mates[0].shape
    what = (f"{n} paired {rl} bp fragments" if len(bs) == 2
            else f"{n} single-end {rl} bp reads")

    def run(be):
        return be.submit_pe(*bs, exp) if len(bs) == 2 \
            else be.submit_se(*bs, exp)

    # C = 64 is the main pass; C = 2 overflows every multi-isoform seed
    # and sends those fragments through the escalation pass at 1024 —
    # both must give the oracle's classes (its envelope is 1024 either way)
    ports = {}
    for cap in caps:
        opts = QuantOpts(hit_capacity=cap, hit_capacity_max=1024)
        port = DeviceMapperBackend(index, opts, tidx.device, tindex=tidx)
        t0 = time.time()
        tok = run(port)
        escalated = int(tok[0]["scalars"][72])
        br = port.finish_batch(tok)
        ports[cap] = (br, escalated, time.time() - t0)
    t0 = time.time()
    oracle = RefMapperBackend(index, QuantOpts(hit_capacity=64,
                                               hit_capacity_max=1024))
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
        say(f"oracle -l {lib}: {what} at --hitCapacity {cap} "
            f"--hitCapacityMax 1024 ({escalated} escalated): {len(ref)} eq "
            f"classes, {int(ref_br.mapped.sum())} mapped, identical to the "
            f"refimpl backend (port {t_port:.2f}s, oracle {t_ref:.1f}s)")
    if 2 in ports:
        require(ports[2][1] > 0, "the C = 2 pass escalated no fragment")
    return ref_br


def _device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def phase_stages(torch, index, tidx, batches, card):
    """Where a batch's time goes at the main path's batch size.  Pass 1
    closes each stage with a synchronize; pass 2 runs the batches as
    quant does (one-deep pipeline, no extra syncs) under torch.profiler,
    which gives the device's busy time against the wall time."""
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.libformat import parse_library_format
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
        return None
    scan = [e for e in evts if "mmp_scan" in e.key]
    scan_us = sum(_device_us(e) for e in scan)
    say(f"profile: {len(fq)} batches pipelined as quant runs them: wall "
        f"{wall_us / 1e3:.3f} ms under the profiler, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
        f"{100 - 100 * busy_us / wall_us:.1f}%); scan kernel "
        f"{scan_us / 1e3:.3f} ms ({100 * scan_us / busy_us:.1f}% of busy) "
        f"[{card}]")
    for e in evts[:8]:
        say(f"profile kernel: {_device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    # the scan kernel alone, as the profiler times it inside the pipeline
    return scan_us / 1e3 / max(sum(e.count for e in scan), 1)


def phase_end_to_end(torch, cli, wdir, idx_dir, tag, lib, mates, batch,
                     card, em_check=False):
    """One `quant` run through the CLI entry point on the reads of
    `mates` ((m1, m2) paired, (m,) single-end), with the scan kernel's
    launch count reset before and read after; outputs checked."""
    from sailfish_tpu_torch.eqclass.io import read_eq_classes
    from sailfish_tpu_torch.infer.em import run_em
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda

    paths = []
    for i, m in enumerate(mates, 1):
        paths.append(os.path.join(wdir, f"reads_{tag}_{i}.fq"))
        write_fastq(paths[-1], m)
    n, rl = mates[0].shape
    reads = ["-1", paths[0], "-2", paths[1]] if len(mates) == 2 \
        else ["-r", paths[0]]
    out = os.path.join(wdir, f"quant_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    mmp_scan_cuda.launches = 0
    t0 = time.time()
    rc = cli.main(["quant", "-i", idx_dir, "-l", lib, *reads,
                   "-o", out, "--hitCapacity", "64", "--hitCapacityMax",
                   "1024", "--dumpEq", "--batchSize", str(batch)])
    wall = time.time() - t0
    launches = mmp_scan_cuda.launches
    require(rc == 0, f"quant -l {lib} exited {rc}")
    require(launches > 0, f"quant -l {lib} ({tag}) launched the scan "
            "kernel 0 times")

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
    require(meta["num_mapped"] > 0.5 * n, f"only {meta['num_mapped']} of "
            f"{n} mapped")
    require(abs(vals[:, 3].sum() - meta["num_mapped"])
            <= 1e-3 * meta["num_mapped"] + 1, "NumReads != mapped")
    eq_path = os.path.join(out, "aux", "eq_classes.txt")
    require(os.path.exists(eq_path), "aux/eq_classes.txt missing")
    _, eq = read_eq_classes(eq_path)
    bms = qt["batch_ms"]
    steady = (f"{batch * (len(bms) - 1) / (sum(bms[1:]) / 1e3):.0f} reads/s "
              "after the first batch" if len(bms) > 1 else "one batch")
    kind = (f"paired {rl} bp fragments" if len(mates) == 2
            else f"single-end {rl} bp reads")
    say(f"quant -l {lib} ({tag}): {n} {kind} in {len(bms)} batches, "
        f"mapping rate "
        f"{100.0 * meta['num_mapped'] / meta['num_processed']:.2f}%, "
        f"{eq.num_classes} eq classes, {qt['escalated_fragments']} "
        f"fragments escalated to C=1024, kernel launches {launches}, "
        f"TPM sum {tpm:.3f}, on {qt['device']}, CLI wall {wall:.1f}s "
        f"[{card}]")
    say(f"quant -l {lib} ({tag}) batches: ms {bms} | "
        f"{n / qt['mapping_seconds']:.0f} reads/s over the mapping loop, "
        f"{steady} [{card}]")
    say(f"quant -l {lib} ({tag}) EM: {qt['em_iterations']} iterations in "
        f"{qt['inference_seconds']:.3f}s "
        f"({qt['em_iterations'] / max(qt['inference_seconds'], 1e-9):.1f} "
        f"iterations/s, float64) [{card}]")
    if not em_check:
        return launches

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



def phase_bias_oracle(torch, index, tidx, mates, ref_br, card):
    """Bias observations of the device backend against the refimpl
    backend's per-hit replay on the paired oracle sample (`ref_br` is
    that sample's refimpl mapping from phase_oracle): read_bias_counts
    and observed_gc equal integer for integer, also through the
    escalation pass."""
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import (
        DeviceMapperBackend,
        RefMapperBackend,
    )
    from sailfish_tpu_torch.stats.bias import BiasState

    exp = parse_library_format("IU")
    b1, b2 = (_fastq_batch(m) for m in mates)
    for flags, cap in ((dict(bias_correct=True), 64),
                       (dict(gc_bias_correct=True), 64),
                       (dict(bias_correct=True), 2),
                       (dict(gc_bias_correct=True), 2)):
        opts = QuantOpts(hit_capacity=cap, hit_capacity_max=1024, **flags)
        oracle = RefMapperBackend(index, opts)
        want = BiasState(opts)
        want.observe_batch(index, b1, oracle.finish_batch_fast(
            ref_br, oracle.accumulator()))
        port = DeviceMapperBackend(index, opts, tidx.device, tindex=tidx)
        bs = port.finish_batch_fast(port.submit_pe(b1, b2, exp),
                                    port.accumulator())
        got = BiasState(opts)
        got.observe_batch(index, b1, bs)
        what = "--biasCorrect" if flags.get("bias_correct") \
            else "--gcBiasCorrect"
        for f in ("read_bias_counts", "observed_gc"):
            a, b = getattr(got, f), getattr(want, f)
            require(np.array_equal(a, b), f"bias oracle {what} "
                    f"--hitCapacity {cap}: {f} differs from the refimpl "
                    f"backend's in {int((a != b).sum())} bins")
        require(got.remaining_bias_samples == want.remaining_bias_samples,
                f"bias oracle {what}: sample budgets differ")
        n_obs = (int(got.read_bias_counts.sum()) - 4096
                 if flags.get("bias_correct") else int(got.observed_gc.sum()))
        require(n_obs > b1.count // 2, f"bias oracle {what}: only {n_obs} "
                f"observations from {b1.count} fragments")
        if not flags.get("bias_correct"):
            require(n_obs == got.gc_slots, f"GC histogram sums to {n_obs}, "
                    f"the device counted {got.gc_slots} slots")
        require(cap != 2 or bs.num_escalated > 0,
                "the C = 2 pass escalated no fragment")
        say(f"bias oracle {what} --hitCapacity {cap}: {b1.count} paired "
            f"fragments ({bs.num_escalated} escalated), {n_obs} observations,"
            f" read_bias_counts and observed_gc identical to the refimpl "
            f"backend's [{card}]")


def phase_bias_stage(torch, index, tidx, batch, card):
    """What bias observation adds to a batch's device work
    (`map_prefetched`, closed by a synchronize) at the main path's
    batch size."""
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend

    exp = parse_library_format("IU")
    b1, b2 = (_fastq_batch(m) for m in batch)
    ms = {}
    for name, flags in (("off", {}), ("--biasCorrect", {"bias_correct": True}),
                        ("--gcBiasCorrect", {"gc_bias_correct": True})):
        be = DeviceMapperBackend(
            index, QuantOpts(hit_capacity=64, hit_capacity_max=1024, **flags),
            tidx.device, tindex=tidx)
        pf = be.prefetch_pe(b1, b2)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            be.map_prefetched(pf, exp)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        ms[name] = min(times[1:])
        del be
        torch.cuda.empty_cache()
    say(f"stage map_prefetched with bias observation: off {ms['off']:.3f} "
        f"ms, --biasCorrect {ms['--biasCorrect']:.3f} ms "
        f"({ms['--biasCorrect'] - ms['off']:+.3f}), --gcBiasCorrect "
        f"{ms['--gcBiasCorrect']:.3f} ms "
        f"({ms['--gcBiasCorrect'] - ms['off']:+.3f}) [{b1.count} "
        f"fragments/batch, best of 2 after a first call, {card}]")


def _gz(path, dtype):
    import gzip

    with gzip.open(path) as fh:
        return np.frombuffer(fh.read(), dtype=dtype)


def _quant_sf(out):
    with open(os.path.join(out, "quant.sf")) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh][1:]
    return np.array([[float(x) for x in r[1:]] for r in rows])


def _done_stats(out):
    """The `done: {...}` record a CLI run logs last."""
    with open(os.path.join(out, "logs", "sailfish_quant.log")) as fh:
        lines = [ln for ln in fh if "done: " in ln]
    return json.loads(lines[-1].split("done: ", 1)[1])


def run_quant_cli(cli, wdir, idx_dir, tag, argv, *, maps: bool):
    """One `quant` through the CLI entry point with the scan kernel's
    launch count set to 0 before and read after.  A run that maps must
    launch the kernel; a resumed run must not.  Returns (output dir,
    meta_info.json, launches, the run's logged statistics)."""
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda

    out = os.path.join(wdir, f"quant_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    mmp_scan_cuda.launches = 0
    rc = cli.main(["quant", "-i", idx_dir, "-o", out, "--hitCapacity", "64",
                   "--hitCapacityMax", "1024", *argv])
    launches = mmp_scan_cuda.launches
    require(rc == 0, f"quant ({tag}) exited {rc}")
    require((launches > 0) == maps, f"quant ({tag}) launched the scan "
            f"kernel {launches} times")
    with open(os.path.join(out, "aux", "meta_info.json")) as fh:
        meta = json.load(fh)
    require(meta["quant_timings"]["device"].startswith("cuda"),
            f"quant ({tag}) ran on {meta['quant_timings']['device']}")
    vals = _quant_sf(out)
    require(len(vals) > 0 and np.isfinite(vals).all(),
            f"quant ({tag}): quant.sf malformed")
    require(abs(vals[:, 2].sum() - 1e6) <= 1.0,
            f"quant ({tag}): TPM sums to {vals[:, 2].sum()}")
    return out, meta, launches, _done_stats(out)


def _fld_of(out):
    """(pdf, cdf) of the FLD a run observed, from its quant_state.json."""
    from sailfish_tpu_torch.stats.fld import EmpiricalDistribution

    with open(os.path.join(out, "aux", "quant_state.json")) as fh:
        st = json.load(fh)
    hist = np.asarray(st["fl_hist"], dtype=np.int64)
    emp = EmpiricalDistribution(np.arange(len(hist), dtype=np.int64), hist)
    return (emp.pdfvals, emp.cdfvals), st["num_fwd"], st["num_rc"]


def phase_bias_runs(torch, cli, wdir, idx_dir, batch, card):
    """`quant -l IU --biasCorrect` and `--gcBiasCorrect` on the paired
    100 bp library of phase 7, through the CLI."""
    reads = ["-l", "IU", "-1", os.path.join(wdir, "reads_pe100_1.fq"),
             "-2", os.path.join(wdir, "reads_pe100_2.fq")]
    outs, launches = {}, {}
    for tag, flag in (("bias_seq", "--biasCorrect"),
                      ("bias_gc", "--gcBiasCorrect")):
        t0 = time.time()
        out, meta, launches[tag], st = run_quant_cli(
            cli, wdir, idx_dir, tag,
            [*reads, flag, "--dumpEq", "--batchSize", str(batch)], maps=True)
        wall = time.time() - t0
        qt = meta["quant_timings"]
        vals = _quant_sf(out)
        require((vals[:, 1] > 0).all(), f"{flag}: an effective length is "
                "not positive")
        plain = _quant_sf(os.path.join(wdir, "quant_pe100"))
        changed = int((vals[:, 1] != plain[:, 1]).sum())
        obs = _gz(os.path.join(out, "aux", "observed_bias.gz"), np.int32)
        gc = _gz(os.path.join(out, "aux", "observed_gc.gz"), np.int32)
        require(obs.shape == (4096,) and gc.shape == (101,),
                f"{flag}: observed files malformed")
        require(int(obs.sum()) == 4096 + qt["bias_samples"],
                f"{flag}: observed_bias.gz sums to {int(obs.sum())}, not "
                f"4096 + {qt['bias_samples']} samples")
        require(int(gc.sum()) == qt["bias_gc_slots"],
                f"{flag}: observed_gc.gz sums to {int(gc.sum())}, the device "
                f"counted {qt['bias_gc_slots']} paired slots")
        n_obs = qt["bias_samples"] if tag == "bias_seq" else int(gc.sum())
        require(n_obs > meta["num_mapped"] // 2, f"{flag}: {n_obs} "
                f"observations from {meta['num_mapped']} mapped fragments")
        upd = qt["bias_update_seconds"]
        say(f"quant -l IU {flag}: {meta['num_processed']} fragments, "
            f"{n_obs} observations, EM {qt['em_iterations']} iterations in "
            f"{qt['inference_seconds']:.3f}s with {len(upd)} "
            f"update_effective_lengths calls ({upd} s each, peak "
            f"{qt['bias_update_peak_bytes'] / 2**30:.3f} GiB allocated "
            f"during inference), {changed} of {len(vals)} effective lengths "
            f"changed, kernel launches {launches[tag]}, batch ms "
            f"{qt['batch_ms']}, CLI wall {wall:.1f}s [{card}]")
        outs[tag] = (out, meta, len(upd))
    return outs, launches


def phase_bias_update(torch, cut, full_text_index, outs, card):
    """`update_effective_lengths` on the card against the same function
    on the CPU, rtol 1e-9, on the world's first transcripts (`cut`: their
    text, offsets and lengths) with the observations, abundances,
    effective lengths and FLD of the CLI runs.  A run whose EM converged
    before iteration 50 never called the function: it is then also
    called once at full width on that run's final alphas, so that it is
    exercised and timed."""
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.stats.bias import (
        BiasState,
        make_bias_text,
        update_effective_lengths,
    )

    nt = len(cut.txp_lens)
    for tag, flags in (("bias_seq", dict(bias_correct=True)),
                       ("bias_gc", dict(gc_bias_correct=True))):
        out, meta, n_updates = outs[tag]
        opts = QuantOpts(**flags)
        vals = _quant_sf(os.path.join(os.path.dirname(out), "quant_pe100"))
        fld, num_fwd, num_rc = _fld_of(out)
        obs = _gz(os.path.join(out, "aux", "observed_bias.gz"), np.int32)
        gc = _gz(os.path.join(out, "aux", "observed_gc.gz"), np.int32)

        def run(index, device, sl):
            state = BiasState(opts)
            state.read_bias_counts = obs.astype(np.int64)
            state.observed_gc = gc.astype(np.int64)
            text = make_bias_text(index, device, opts)
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eff = update_effective_lengths(
                opts, text, state, fld, vals[sl, 1], vals[sl, 3], num_fwd,
                num_rc)
            if device == "cuda":
                torch.cuda.synchronize()
            return eff, state, time.perf_counter() - t0

        sl = slice(0, nt)
        g, sg, t_g = run(cut, "cuda", sl)
        c, sc, t_c = run(cut, "cpu", sl)
        active = int((vals[sl, 3] >= 1e-8).sum())
        require(active > 0 and ((sg.expected_seq_bias != 1).any()
                                or (sg.expected_gc != 1).any()),
                f"update_effective_lengths {tag}: no transcript of the cut "
                "is active")
        changed = int((g != vals[sl, 1]).sum())
        for name, a, b in (("effective lengths", g, c),
                           ("expected_seq_bias", sg.expected_seq_bias,
                            sc.expected_seq_bias),
                           ("expected_gc", sg.expected_gc, sc.expected_gc)):
            require(np.allclose(a, b, rtol=1e-9, atol=0),
                    f"update_effective_lengths {tag}: {name} differ between "
                    "cuda and cpu beyond rtol 1e-9")
        rel = float(np.max(np.abs(g - c) / np.abs(c)))
        say(f"update_effective_lengths {tag} cuda vs cpu: first {nt} "
            f"transcripts ({len(cut.codes)} text positions, {active} "
            f"active, {changed} effective lengths changed), rtol 1e-9 holds "
            f"(max rel diff {rel:.3g}); cuda "
            f"{t_g:.3f}s, cpu {t_c:.3f}s [{card}]")
        if n_updates == 0:
            eff, _, t_full = run(full_text_index, "cuda", slice(None))
            require(np.isfinite(eff).all() and (eff > 0).all(),
                    f"update_effective_lengths {tag} at full width: bad "
                    "effective lengths")
            say(f"update_effective_lengths {tag} at full width, called "
                f"directly (the run's EM converged at iteration 50, before "
                f"its first update): {t_full:.3f}s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                f"allocated [{card}]")


def _rel_dev(mat, point, sel):
    """|mean over the samples - point| / point on the transcripts `sel`."""
    return np.abs(mat.mean(axis=0)[sel] / point[sel] - 1)


def phase_resume_samplers(torch, cli, wdir, idx_dir, card):
    """From the eq-class dump of the paired run of phase 7: plain resume,
    bootstrap (EM and VBEM) and Gibbs, each through the CLI."""
    from sailfish_tpu_torch.eqclass.io import read_eq_classes
    from sailfish_tpu_torch.infer.gibbs import (
        _build_schedule,
        color_classes,
        schedule_launches,
    )

    src = os.path.join(wdir, "quant_pe100")
    base = _quant_sf(src)
    resume = ["-l", "IU", "--resumeFromEq", src]
    out, meta, _, st = run_quant_cli(cli, wdir, idx_dir, "resumed", resume,
                                     maps=False)
    got = _quant_sf(out)
    require(np.allclose(got[:, 3], base[:, 3], rtol=1e-9, atol=1e-9)
            and np.array_equal(got[:, 1], base[:, 1]),
            "the resumed run's quant.sf differs from the dumping run's")
    with open(os.path.join(src, "aux", "meta_info.json")) as fh:
        src_meta = json.load(fh)
    require(meta["num_processed"] == src_meta["num_processed"]
            and meta["num_mapped"] == src_meta["num_mapped"],
            "the resumed run's counters differ from the dumping run's")
    say(f"resume: --resumeFromEq of the paired run's dump gives its "
        f"quant.sf (NumReads rtol 1e-9, effective lengths equal: the FLD "
        f"came back from quant_state.json), {meta['num_mapped']} mapped, "
        f"0 kernel launches [{card}]")
    T, mapped = len(base), meta["num_mapped"]
    busy = base[:, 3] > 100

    def samples(tag, flags, dtype):
        out, meta, _, st = run_quant_cli(cli, wdir, idx_dir, tag,
                                         [*resume, *flags], maps=False)
        mat = _gz(os.path.join(out, "aux", "bootstrap", "bootstraps.gz"),
                  dtype)
        require(mat.shape == (16 * T,), f"{tag}: bootstraps.gz holds "
                f"{mat.shape[0]} values of {np.dtype(dtype).name}, not 16 x "
                f"{T}")
        return mat.reshape(16, T), _quant_sf(out)[:, 3], meta, st

    for tag, flags, rtol in (("boot_em", [], 1e-6),
                             ("boot_vbem", ["--useVBOpt"], 2e-2)):
        mat, point, meta, st = samples(
            tag, ["--numBootstraps", "16", *flags], np.float64)
        require(meta["samp_type"] == "bootstrap"
                and meta["num_bootstraps"] == 16, f"{tag}: meta_info.json "
                f"says {meta['samp_type']}, {meta['num_bootstraps']}")
        dev_sum = float(np.abs(mat.sum(axis=1) / mapped - 1).max())
        require(dev_sum <= rtol, f"{tag}: a replicate sums to the mapped "
                f"count only within {dev_sum:.3g} (rtol {rtol})")
        sel = point > 100
        dev_mean = _rel_dev(mat, point, sel).max(initial=0.0)
        require(dev_mean <= 0.15, f"{tag}: the replicate mean is off the "
                f"point estimate by {dev_mean:.3f} on a transcript with "
                "more than 100 reads")
        # the world spreads its fragments thin, so few transcripts pass
        # 100 reads: over all of them the replicate mean must at least
        # follow the point estimate (VBEM replicates are sparser than
        # their point estimate; the readings are printed)
        mid = float(np.median(_rel_dev(mat, point, point > 10)))
        r = float(np.corrcoef(mat.mean(axis=0), point)[0, 1])
        require(r >= 0.5, f"{tag}: replicate means and point estimates "
                f"correlate at {r:.3f} only")
        require(float(mat.std(axis=0).max()) > 0, f"{tag}: replicates equal")
        say(f"bootstrap {' '.join(flags) or 'EM'}: 16 replicates of {T} "
            f"float64 in {st['sampler_seconds']:.3f}s "
            f"({16 / st['sampler_seconds']:.2f} replicates/s, drawing "
            f"included); sums within {dev_sum:.3g} of {mapped} mapped, mean "
            f"within {dev_mean:.4f} of the point estimate on "
            f"{int(sel.sum())} transcripts over 100 reads, median deviation "
            f"{mid:.4f} on {int((point > 10).sum())} over 10 reads, "
            f"correlation {r:.4f} over all [{card}]")

    mat, point, meta, st = samples("gibbs", ["--numGibbsSamples", "16"],
                                   np.int32)
    require(meta["samp_type"] == "gibbs", f"gibbs: meta_info.json says "
            f"{meta['samp_type']}")
    require((mat.sum(axis=1, dtype=np.int64) == mapped).all(),
            "a Gibbs sample does not sum to the mapped count")
    require((mat >= 0).all() and float(mat.std(axis=0).max()) > 0,
            "Gibbs samples negative or all equal")
    dev_mean = _rel_dev(mat, base[:, 3], busy).max(initial=0.0)
    mid = float(np.median(_rel_dev(mat, base[:, 3], base[:, 3] > 10)))
    _, eq = read_eq_classes(os.path.join(src, "aux", "eq_classes.txt"))
    size = schedule_launches(_build_schedule(eq, color_classes(eq)))
    # 16 samples from 4 chains: 4 sweeps of 10 rounds for each chain
    launches = size["launches_per_round"] * 10 * 4 * 4
    say(f"gibbs: 16 samples of {T} int32 in {st['sampler_seconds']:.3f}s "
        f"({16 / st['sampler_seconds']:.2f} samples/s, schedule and init "
        f"included), each sums to {mapped} exactly, mean within "
        f"{dev_mean:.4f} of the point estimate on {int(busy.sum())} "
        f"transcripts over 100 reads, median deviation {mid:.4f} on those "
        f"over 10 reads; schedule {size['waves']} waves in "
        f"tiers {size['tiers']}, {size['chain_steps']} chain steps a round: "
        f"{size['launches_per_round']} launches a round and chain, "
        f"{launches} for the 16 samples (4 chains x 4 sweeps x 10 rounds) "
        f"[{card}]")


def phase_libraries_checkpoint(torch, cli, wdir, idx_dir, batch, card):
    """Two libraries in one run against the two single-library runs of
    phase 7, and --checkpointInterval on the paired run."""
    import sailfish_tpu_torch.quant as quant
    from sailfish_tpu_torch.eqclass.io import merge_eq_dumps, read_eq_classes

    def classes(eq):
        return dict(zip(eq.labels(), eq.counts.tolist()))

    def dump(tag):
        return os.path.join(wdir, f"quant_{tag}", "aux", "eq_classes.txt")

    m1, m2 = (os.path.join(wdir, f"reads_pe100_{i}.fq") for i in (1, 2))
    se = os.path.join(wdir, "reads_se100_1.fq")
    launches = {}
    out, meta, launches["two_libraries"], _ = run_quant_cli(
        cli, wdir, idx_dir, "two_libraries",
        ["-l", "IU", "-1", m1, "-2", m2, "-l", "U", "-r", se, "--dumpEq",
         "--batchSize", str(batch)], maps=True)
    singles = []
    for tag in ("pe100", "se100"):
        with open(os.path.join(wdir, f"quant_{tag}", "aux",
                               "meta_info.json")) as fh:
            singles.append(json.load(fh))
    for key in ("num_processed", "num_mapped"):
        require(meta[key] == sum(s[key] for s in singles),
                f"two libraries: {key} {meta[key]} is not the sum of the "
                "single-library runs'")
    _, want = merge_eq_dumps([dump("pe100"), dump("se100")])
    _, got = read_eq_classes(dump("two_libraries"))
    require(classes(got) == classes(want), "two libraries: eq_classes.txt "
            "is not the class-wise sum of the single-library runs' dumps")
    with open(os.path.join(out, "lib_format_counts.json")) as fh:
        require(json.load(fh)["expected_format"] == "IU;U",
                "two libraries: expected_format is not IU;U")
    say(f"two libraries -l IU -1 -2 -l U -r: {meta['num_processed']} "
        f"fragments = {singles[0]['num_processed']} + "
        f"{singles[1]['num_processed']}, {got.num_classes} eq classes equal "
        f"to the sum of the two runs' dumps, kernel launches "
        f"{launches['two_libraries']} [{card}]")

    seen = []
    real = quant._write_checkpoint

    def recording(aux_path, names, eq, state):
        real(aux_path, names, eq, state)
        seen.append((int(state.num_observed), eq.total_count(), all(
            os.path.exists(os.path.join(aux_path, f))
            for f in ("eq_classes.txt", "quant_state.json"))))

    quant._write_checkpoint = recording
    try:
        out, meta, launches["checkpoint"], _ = run_quant_cli(
            cli, wdir, idx_dir, "checkpoint",
            ["-l", "IU", "-1", m1, "-2", m2, "--checkpointInterval",
             str(batch), "--dumpEq", "--batchSize", str(batch)], maps=True)
    finally:
        quant._write_checkpoint = real
    require(len(seen) >= 2 and seen[0][0] == batch and seen[0][2]
            and 0 < seen[0][1] < seen[-1][1],
            f"checkpoints: {seen}, none after the first batch of {batch}")
    _, got = read_eq_classes(dump("checkpoint"))
    _, want = read_eq_classes(dump("pe100"))
    require(classes(got) == classes(want), "the checkpointed run's "
            "eq_classes.txt differs from the run's without checkpoints")
    say(f"checkpoints --checkpointInterval {batch}: written at "
        f"{[n for n, _, _ in seen]} fragments (the first holds "
        f"{seen[0][1]} mapped), final eq_classes.txt equal to the run's "
        f"without, kernel launches {launches['checkpoint']} [{card}]")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--bases", type=float, default=150e6)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--kernel-frags", type=int, default=8192)
    ap.add_argument("--oracle-frags", type=int, default=2048)
    ap.add_argument("--bias-txps", type=int, default=2000,
                    help="transcripts of the card-against-CPU run of "
                    "update_effective_lengths")
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after the kernel comparison; no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from sailfish_tpu_torch import cli
        from sailfish_tpu_torch.index.builder import load_index
        from sailfish_tpu_torch.index.device import TorchIndex
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    try:
        phase_toolchain(torch)
        smi = nvidia_smi_line()
        copy_rate = phase_copy_bandwidth(torch, smi)
        kernels = [] if args.kernel_only else [phase_ubench(torch, smi)]
        note("ubench done")
        idx_dir, wdir, batches, long_batch, xl, seqs = phase_world(args,
                                                                    cli)
        note("world ready")
        t0 = time.time()
        index = load_index(idx_dir)
        tidx = TorchIndex.from_quasi_index(index, "cuda")
        say(f"index on card: {tidx.n_text} text positions, 2^"
            f"{tidx.ht_bits} k-mer buckets, probe chain <= "
            f"{tidx.ht_probes} (load + upload {time.time() - t0:.1f}s)")
        kf, of = args.kernel_frags, args.oracle_frags
        # the lane blocks of the three runs below, whole and unchanged
        kv = {}
        main_case = [{"cand_cap": 64}]
        for tag, mates in (("paired_batch", batches[0]),
                           ("single_end_batch", batches[0][:1]),
                           ("long_batch", long_batch)):
            kv.update(phase_kernel_vs_plain(
                torch, tidx, tag, _mate_reads(mates, False), main_case, smi,
                copy_rate))
        # a sample with Ns.  64: the main pass, under both skip rules;
        # 1024: the escalation pass; 2: a capacity that the gene families
        # overflow, so the kernel's cnt > C branch is held against the
        # plain version too
        for mates, cases in (
                (tuple(m[:kf] for m in batches[0]),
                 main_case + [{"cand_cap": 64, "skip_jump": True},
                              {"cand_cap": 1024}, {"cand_cap": 2}]),
                (tuple(m[:kf] for m in long_batch), main_case),
                (xl, main_case)):
            kv.update(phase_kernel_vs_plain(
                torch, tidx, "sample", _mate_reads(mates, True), cases, smi,
                copy_rate))
        # the risk reads, 16 seeds of them, with step budgets that end
        # before, at and behind a 32-position probe window
        L100 = (READ_LEN + 7) // 8 * 8
        risk = [risk_reads(seqs, tidx.k, L100, seed) for seed in range(16)]
        risk = (np.concatenate([r[0] for r in risk]),
                np.concatenate([r[1] for r in risk]))
        kv.update(phase_kernel_vs_plain(
            torch, tidx, "risk", (*risk, f"{len(risk[1])} risk reads"),
            [{"cand_cap": 64, "max_steps": st} for st in (1, 31, 32, 33)]
            + main_case
            + [{"cand_cap": 64, "skip_jump": True},
               {"cand_cap": 64, "skip_jump": True, "max_steps": 33},
               {"cand_cap": 2}, {"cand_cap": 2, "max_steps": 33}],
            smi, copy_rate))
        del seqs
        note("kernel vs plain done")
        if args.kernel_only:
            say(json.dumps({"scan_shapes": kv}))
            say(smi)
            return 0
        sample = tuple(m[:of] for m in batches[0])
        ref_br = phase_oracle(torch, index, tidx, sample, "IU", (64, 2))
        phase_oracle(torch, index, tidx, (batches[0][0][:of],), "U", (64,))
        phase_oracle(torch, index, tidx,
                     tuple(m[:of // 2] for m in long_batch), "IU", (64,))
        note("oracle done")
        profiled_ms = phase_stages(torch, index, tidx, batches, smi)
        note("stages done")
        phase_bias_oracle(torch, index, tidx, sample, ref_br, smi)
        phase_bias_stage(torch, index, tidx, batches[-1], smi)
        note("bias oracle done")
        # the text of the first transcripts, for the card-against-CPU run
        # of update_effective_lengths
        import types
        nt = min(args.bias_txps, index.num_transcripts)
        end = int(index.txp_offsets[nt - 1] + index.txp_lens[nt - 1]) + 1
        cut = types.SimpleNamespace(
            codes=index.codes[:end].copy(),
            txp_offsets=index.txp_offsets[:nt].copy(),
            txp_lens=index.txp_lens[:nt].copy())
        whole = types.SimpleNamespace(
            codes=index.codes, txp_offsets=index.txp_offsets,
            txp_lens=index.txp_lens)
        del tidx, index, ref_br
        torch.cuda.empty_cache()
        launches = phase_end_to_end(
            torch, cli, wdir, idx_dir, "pe100", "IU",
            tuple(np.concatenate([b[i] for b in batches]) for i in (0, 1)),
            args.batch, smi, em_check=True)
        launches_se = phase_end_to_end(
            torch, cli, wdir, idx_dir, "se100", "U",
            (np.concatenate([b[0] for b in batches]),), args.batch, smi)
        launches_long = phase_end_to_end(
            torch, cli, wdir, idx_dir, f"pe{LONG_READ_LEN}", "IU",
            long_batch, args.batch, smi)
        note("end to end done")
        bias_outs, more_launches = phase_bias_runs(torch, cli, wdir, idx_dir,
                                                   args.batch, smi)
        phase_bias_update(torch, cut, whole, bias_outs, smi)
        note("bias done")
        phase_resume_samplers(torch, cli, wdir, idx_dir, smi)
        note("resume and samplers done")
        more_launches.update(phase_libraries_checkpoint(
            torch, cli, wdir, idx_dir, args.batch, smi))
        note("libraries and checkpoints done")
        require("jax" not in sys.modules
                and "sailfish_tpu" not in sys.modules,
                "jax or the JAX package was imported")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # ms, plain_ms and bound_ms are those of one launch of the paired
    # run; "shapes" holds every shape compared, the three that a run
    # launched with that run's count
    for key, n in ((f"paired_batch_L{L100}_C64", launches),
                   (f"single_end_batch_L{L100}_C64", launches_se),
                   (f"long_batch_L{LONG_READ_LEN}_C64", launches_long)):
        kv[key]["launches"] = n
    main_kv = kv[f"paired_batch_L{L100}_C64"]
    kernels.insert(0, {
        "name": "mmp_scan", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in kv.values()),
        "ms": main_kv["ms"], "plain_ms": main_kv["plain_ms"],
        "bound_ms": main_kv["bound_ms"], "bound_by": main_kv["bound_by"],
        "library_ms": None,
        "profiled_kernel_ms_per_launch": profiled_ms,
        # the scan kernel's count in each later CLI run that maps (bias,
        # two libraries, checkpoints), set to 0 before each
        "launches_by_run": {"pe100": launches, "se100": launches_se,
                            f"pe{LONG_READ_LEN}": launches_long,
                            **more_launches},
        "shapes": kv,
    })
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
