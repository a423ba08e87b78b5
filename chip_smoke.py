#!/usr/bin/env python3
"""On-card smoke run of the torch port (sailfish_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # the full-size run, one card

Phases (each prints its lines; any failure exits non-zero before the
result line):
  1. toolchain: card, power limit, nvcc, triton, the build of the CUDA
     kernels (csrc/mmp_scan.cu, csrc/ubench.cu, csrc/em.cu) and of the
     native host helpers (g++), the card's copy bandwidth
  2. ubench: each of the 17 op-chain variants of csrc/ubench.cu against
     its plain version at 2,048 iterations from seeded buffers (exact
     int32 equality), then `python -m sailfish_tpu_torch.ubench --iters
     100000` through its entry point: ns per iteration of each variant;
     `empty` must be the fastest
  3. world: a gene-family transcriptome (isoforms share exons; ~200k
     transcripts, ~150 Mb, numpy seed 7 — the GENCODE-scale world of
     tools/bench_gencode.py) written as FASTA and indexed with
     `python -m sailfish_tpu_torch.cli index -k 31` into .smoke_cache/
     (reused when present; the native SA-IS is required at this scale),
     and at the same time as 4 shards with `index -k 31 --indexShards 4`
     in a process of its own;
     2 batches of 65,536 paired 100 bp fragments with 0.5% substitutions
     (seed 11) and 1 batch of 65,536 paired 152 bp fragments (seed 13)
     written as FASTQ
  4. kernel vs plain: the CUDA scan, run into buffers filled with 0xFF,
     and its plain torch version on the same card tensors: all four
     outputs equal bit for bit (every slot written), equal after the
     post-pass, both timed, with the least time the card could take for
     the same bytes and operations, and the table rows the kernel read
     beside those the scan needs; on the prefix route and at every facts
     launch also the 16-byte text chunks its compare read beside those
     that a compare stopping at each candidate's first mismatching chunk
     needs (the plain version's `work["chunks"]`), never fewer.
     First the three lane blocks that the runs of phase 7 give the
     kernel, whole and unchanged, at C = 64: a batch of 65,536 paired
     100 bp fragments (both mates, fwd + rc: 262,144 lanes, L = 104),
     its first mates as a single-end batch (131,072 lanes) and a batch
     of paired 152 bp fragments (262,144 lanes, L = 152); the paired
     batch also under the jump rule, the launch of phase 15's world 1.
     Then a
     sample of 8,192 fragments with an N in every 7th read: C = 64,
     C = 64 under the jump rule, C = 1024 (the escalation pass) and
     C = 2, where lanes must overflow, at L = 104, and C = 64 at L = 152
     and L = 304.  Last the risk reads (ragged lengths, the text's tail,
     Ns on k-mer edges, miss chains that cross a probe window) at step
     budgets of 1, 31, 32, 33 and L, under both skip rules, at C = 64
     and C = 2.
     Then the prefix route (`sf_mmp_scan_prefix`) on the world's index
     at k = 15 without a k-mer table (the k = 31 index's text and suffix
     array, the rest recomputed by `QuasiIndex.from_arrays`): the paired
     batch's lane block at C = 64 and the sample at C = 64, 1024 and 2,
     as above; the facts, replay and slot modes on that index as one
     shard against their plain versions and against the prefix scan's
     raw outputs.  Then the 4-shard index: the modes against their plain
     versions on a sample (every shard); the paired batch's sharded map
     against the monolithic map (each lane's valid slots in order, mlen,
     overflow), both timed, and `map_prefetched` of both backends; the
     facts, replay and slot kernels timed on that batch with their
     bounds.  The replay in both of its modes: the shards mode (the k-mer
     route's: the merge inside the kernel) and the plane mode (over the
     torch merge's facts, the prefix route's), each against its plain
     version, its bound counted in the 32-byte sectors the advance
     visits, and the torch merge timed beside the shards mode.
     Then the 64-bit instantiation (`sf_mmp_scan64`) on the big_sa layout
     of the same index (its arrays cast to int64, as force_big_sa builds
     them): on the three lane blocks and on the sample at C = 64, 1024
     and 2, all four raw outputs equal to its plain version's and to the
     32-bit instantiation's, bit for bit into 0xFF buffers, timed in turns
     with the 32-bit one.  Last positions and suffix-array indices above
     2^31 (a shifted copy of the index, 26 GiB) and above 2^32 (base
     pointers moved back, table lo with a high word): outputs equal to
     the unshifted run's
  5. oracle: eq-class labels and counts of a sample of fragments from
     the port's device backend equal its `--backend refimpl` backend
     (the numpy reference mapper): paired 100 bp at --hitCapacity 64 and
     at --hitCapacity 2, where fragments take the escalation pass;
     single-end 100 bp reads (-l U); paired 152 bp (the bench's
     `oracle_check`, sailfish_tpu_torch/bench.py)
  6. stages: the batches pipelined as quant runs them under
     torch.profiler at the main path's batch size: per-batch host ms of
     each stage from the port's spans (pack, copy, enqueue, fold, host
     syncs), device busy and idle share, top kernels (the bench's
     `stage_breakdown`)
  7. end to end, each through the CLI entry point with the kernels'
     launch counters reset before and read after, outputs checked (TPM
     sums to 1e6, the run was on cuda): `quant -l IU --hitCapacity 64
     --hitCapacityMax 1024 --dumpEq` on the paired 100 bp reads, its EM
     rerun through csrc/em.cu on the card and on the CPU (the same
     iterations, alphas at rtol 1e-6), then the kernel's ms a solve
     beside its bound, its floor (classes of two transcripts) and the
     plain loop's ms on the card, timed apart from the gate; `quant -l U
     -r` on their first mates as a single-end library, and `quant -l IU`
     on the paired 152 bp reads.  Each of these runs, and each bias run
     of phase 8, must launch the EM kernel once a solve (once, or once a
     bias segment); the kernel row's launches are theirs
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
 11. 64-bit index: the world's index saved in the big_sa layout by the
     port's builder; `quant -l IU` on it gives phase 7's eq_classes.txt
     and quant.sf (rtol 1e-9), `--gcBiasCorrect` phase 8's
 12. launcher: `quant --numShards 2` (no --shardId), two shard
     processes on the one card: the single run's eq classes as a set of
     lines, and the quant.sf of the route from the same shard runs
     (`--shardId 0/1 --mapOnly`, then `mergeeq`, their states added up
     by the script and `--resumeFromEq`; rtol 1e-9); its mapping seconds
     beside the single process's; `--numShards 2 --biasCorrect` exits 2
 13. k = 15: `quant -l IU --dumpEq` on the k = 15 index directory on the
     oracle sample, device backend against `--backend refimpl`:
     eq_classes.txt identical, quant.sf at rtol 1e-9, the prefix kernel
     launched
 14. sharded: `quant -l IU --dumpEq` on the 4-shard directory on the
     paired 100 bp library of phase 7: eq_classes.txt identical to the
     monolithic run's, quant.sf at rtol 1e-9, the facts, replay (shards
     mode) and slot kernels launched, and neither the monolithic scan
     nor the replay's plane mode, and no torch merge (`FactsMerge`) built
 15. dist: the data-parallel step (sailfish_tpu_torch/parallel/dist.py)
     on the world's k = 31 index and the first paired batch, its ranks
     spawned by `dist.spawn` as `python -m
     sailfish_tpu_torch.parallel.dist` spawns them, each loading the
     index from .smoke_cache: world 1 on NCCL, whose merged eq table must
     equal `expected_eq_table` of the device backend's exact classes of
     the same batch slot for slot (and alpha sum to the mapped count);
     world 2 on gloo, both ranks on the one card, equal to world 1
     (alpha at rtol 1e-5, the rest exactly); the prefix route
     (`use_hash=False` on the same arrays) on 2,048 fragments on the
     card, equal to the same step on the CPU (plain versions, its own
     process, started after the card's ranks have ended); the scan kernels' launches in each; the step's ms beside
     `map_prefetched`'s on the same batch, one step under torch.profiler,
     and the step's EM update alone on a label matrix of the batch's
     shape, with its `index_add_` timed both ways (PAD zeros spread over
     the bins, and all on bin 0)
 16. bench: `python -m sailfish_tpu_torch.bench`, a process for each
     world, as a user runs it: `--world uniform` (bench.py's world of
     20,000 random transcripts, its index cached in .smoke_cache/, 2
     warm-up and 12 timed batches of 65,536 paired fragments) and
     `--world gencode` on phase 3's k = 31 index (--bench-reads 2M
     fragments, 30 timed batches, EM, 16 bootstraps, 16 Gibbs samples,
     the stage breakdown); every metric line present, finite and from
     cuda, each run's `--check` (512 fragments against the reference
     mapper) passed, the scan kernel launched in each timed loop
 17. capacity: `python -m sailfish_tpu_torch.capacity_envelope --mode
     repeat` through its parser and `run`, the launch counts reset before
     and read after each run: at the tool's defaults (2,048 fragments,
     --hitCapacityMax 256 and 2048) and at one production batch
     (65,536 fragments; caps 256, 1024 and 2048), each at
     --hitCapacity 64 on the repeat world (a 300 bp element in about
     400 of 4,000 transcripts).  Gates: fragments escalated at 256 and
     an element interval wider than 256; one main-pass launch a cap and
     one a 1,024-fragment escalation chunk; mapped sets that grow with
     the cap; each cap's wide pass run again through its backend's own
     escalation chunks on the fragments its main pass overflowed, whose
     labels and mapped flags equal the next cap's wherever it did not
     overflow and give the tool's mapped flags; on the first 512
     fragments the eq classes and mapped
     flags of the device backend equal the refimpl backend's at each
     cap (the bench's `oracle_check`); the scan kernel on the first
     escalation chunk at C = 256 and 2048 against its plain version, as
     in phase 4.  Readings: the drop count at the CLI's 1024, the ms and
     device memory of an escalation chunk at each cap
 18. shrink (`--scanShrink`, the XLA kernel's compacted scan through
     the scan's step stamps and the cut pass of map/shrink.py): the
     stamped launch against its plain version on phase 4's sample (C =
     64 under both skip rules and C = 2, where lanes overflow; the 64-bit
     index at C = 64; the k = 15 prefix route at C = 64 and 2) and on
     the paired batch, all five raw
     outputs bit for bit (stamps written over a fill no step reaches),
     its other outputs equal to the stampless launch's, timed in turns
     with it; the cut pass on the paired batch's stamps on the card
     against the CPU; `quant -l IU --scanShrink 2 --batchSize 2048` on
     the first 2,048 fragments on cuda against `--device cpu` (eq
     classes identical, quant.sf to its printed digits); then phase 7's
     paired run (two production batches of 65,536 fragments) at
     --scanShrink 2 through the CLI, every launch stamped; its mapped
     share, classes and each batch's ms beside phase 7's at 1
 19. the kernel table line, the nvidia-smi line, then the result line

`--kernel-only` runs phases 1, 3 and 4 (toolchain, world, kernel vs
plain: both widths, the prefix route, the sharded modes) and prints no
result line: the quick way to time a change to the scan kernel.
`--against CHECKOUT [CHECKOUT ...]` runs phases 1 and 3, then times
this tree's scan kernels in turns against those of each other checkout
(for instance the parent commit, unpacked with `git archive` into
`.proof/`) on the paired batch and the sample, and prints no result
line.

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
# what the prefix route and the sharded modes compute, in the XLA kernel
PREFIX_SEED = "sailfish_tpu/map/kernels.py:195"
LOCKSTEP_SCAN = "sailfish_tpu/map/kernels.py:244"
# the XLA kernel's compacted scan (--scanShrink), which the stamps serve
SHRINK_SCAN = "sailfish_tpu/map/kernels.py:341"
UBENCH_SRC = "sailfish_tpu_torch/csrc/ubench.cu"
EM_SRC = "sailfish_tpu_torch/csrc/em.cu"
# the reference mapper's processes in the oracle gates: the host's cores,
# idle while it runs
ORACLE_WORKERS = os.cpu_count() or 1
UBENCH_TPU_KERNEL = "tools/ubench_pallas.py:37"
PREFIX_K = 15          # the k of the world's index without a k-mer table
SHARDS = 4             # shards of the world's sharded index
PLAIN = "the plain version's"
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
        # each instantiation of the scan and of its sharded modes: int32
        # positions or 64-bit ones (`long long`, mangled "x"), the k-mer
        # route (template argument false, "Lb0E") or the prefix route
        kinds = ("mmp_scan", "facts", "slots", "replay", "em_solve")
        if "Compiling entry function" in ln and any(
                f"{kn}_kernel" in ln for kn in kinds):
            kn = next(f"{kn}_kernel" for kn in kinds
                      if f"{kn}_kernel" in ln)
            tail = ln.split(kn, 1)[1]
            what = ", ".join(x for x in (
                "64-bit" if tail.startswith("Ix") else "",
                "prefix route" if "Lb1E" in tail[:8] else "") if x)
            if kn == "replay_kernel":  # the template argument is the mode
                what = "shards mode" if "Lb1E" in tail[:8] else "plane mode"
            if kn == "em_solve_kernel":  # the value type
                what = "float64" if tail.startswith("Id") else "float32"
            say(f"ptxas {kn}{f' ({what})' if what else ''}: " + " | ".join(
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

    from sailfish_tpu_torch import trace, ubench

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
    launches0 = trace.counter("launch.ubench")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ubench.main(["--iters", str(UBENCH_ITERS)])
    launches = trace.counter("launch.ubench") - launches0
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
    from sailfish_tpu_torch.bench import build_transcriptome, simulate_batch
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
    # the sharded index (phases 4 and 14) builds beside this one, through
    # `index --indexShards` in a process of its own
    idx4_dir = os.path.join(wdir, f"index_{SHARDS}shards")
    fresh4 = not os.path.exists(os.path.join(idx4_dir, "header.json"))
    sharded = subprocess.Popen(
        [sys.executable, "-m", "sailfish_tpu_torch.cli", "index", "-t",
         fasta, "-o", idx4_dir, "-k", "31", "--indexShards", str(SHARDS)],
        cwd=ROOT)
    try:
        require(cli.main(["index", "-t", fasta, "-o", idx_dir, "-k",
                          "31"]) == 0, "index build failed")
        say(f"index: {'built' if fresh else 'reused'} in "
            f"{time.time() - t0:.1f}s | suffix array: "
            f"{'native SA-IS' if native else 'numpy prefix doubling'}")
    except BaseException:
        sharded.kill()
        raise
    finally:
        rc4 = sharded.wait()
    require(rc4 == 0, f"sharded index build exited {rc4}")
    say(f"sharded index: {SHARDS} shards, "
        f"{'built' if fresh4 else 'reused'} through `index --indexShards` "
        f"beside it, both in {time.time() - t0:.1f}s")
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
    return idx_dir, idx4_dir, wdir, batches, long_batch, tuple(xl), seqs


def risk_reads(seqs, k, L, seed):
    """Reads that a windowed, chunked scan can get wrong, cut from the
    transcripts `seqs` (uint8 code arrays in text order, each at least L
    bases): (codes (n, L) uint8 padded with code 4, lens (n,) int32).

      - ragged lengths: k - 1, k, L - 1, L and some between
      - reads that end on the last base of the last transcript, and reads
        that run past it (their match ends at the text's final separator)
      - an N at the first, the 16th (k >= 16) and the last base of a
        k-mer, and at the read's last base
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
        for at in (p0, p0 + min(15, k - 1), p0 + k - 1):
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


def _mate_reads(mates, with_n):
    """The mates of the fragments as one block of reads, as the backend
    lays it out (rows [m1; m2], or [m] for a single-end batch): (codes,
    lens, description).  `with_n` puts an N (code 4) at base 37 of every
    7th read: an N hashes as A in the probe key but ends a match in the
    LCP, so such lanes hold the kernel to both."""
    from sailfish_tpu_torch.bench import padded

    codes = np.concatenate([padded(m) for m in mates])
    if with_n:
        codes[::7, 37] = 4
    lens = np.full(codes.shape[0], mates[0].shape[1], np.int32)
    return codes, lens, f"{mates[0].shape[0]} reads x {len(mates)} mates"


def _time_ms(torch, fn, reps, queued=False):
    """ms a call of fn() on the card, by CUDA events around `reps` calls
    after a first one.  With `queued` the calls are queued behind a sleep
    kernel of some 10 ms, so that the time is the device's alone: a call
    whose kernel is shorter than its wrapper's host work (the replay's)
    otherwise reads the host's pace."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def seed_bytes(work, pos_bytes):
    """Bytes the seeds of `work` read: 64 per table row on the k-mer
    route; on the prefix route two table entries per lookup and, per
    search step, a suffix-array entry and a 4-byte packed word."""
    return (64 * work.get("buckets", 0)
            + 2 * pos_bytes * work.get("lookups", 0)
            + (pos_bytes + 4) * work.get("search_steps", 0))


def seed_reads(work):
    """What a kernel's `rows_read` counter counts for these inputs: table
    rows (k-mer route), or lookups and search steps (prefix route)."""
    return (work.get("buckets", 0) + work.get("lookups", 0)
            + work.get("search_steps", 0))


def chunk_count(torch, launch, work, name):
    """One more launch with a chunk counter (`launch(counter)`): the
    16-byte text chunks the kernel's compare read, which must be at least
    the `work["chunks"]` the plain version counts as needed.  Returns
    {"chunks_read", "chunks_needed"} and a phrase for the row's line."""
    n = torch.zeros(1, dtype=torch.int64, device="cuda")
    launch(n)
    got, need = int(n.item()), work["chunks"]
    require(got >= need, f"{name}: the kernel compared {got} chunks, fewer "
            f"than the {need} a compare that stops at a candidate's first "
            "mismatching chunk needs")
    return ({"chunks_read": got, "chunks_needed": need},
            f"text chunks needed {need}, read by the kernel {got} "
            f"({got / max(need, 1):.4f}x)")


def scan_bound(lanes, meta, work, C, M, pos_bytes=4, extra_bytes=0):
    """Least time for one scan call on these inputs.  Bytes that must
    move: per lane L code bytes, 4 L packed-word bytes, its length and
    its 16 bytes of meta; the seeds' reads (`seed_bytes`); a suffix-array
    entry (`pos_bytes`: 4, or 8 for a 64-bit index) and the compared
    text bytes per candidate; per stored candidate its `txp_of_pos`
    entry (4 bytes) and `txp_offsets` entry (`pos_bytes`); on a 64-bit
    index with a k-mer table 4 bytes of the table's side array per seed
    (a k-mer found with cnt <= C); and the M * C slots of 9 bytes per
    lane, each written once, and `extra_bytes` written beside them (the
    step stamps).  Operations: about 40 per probed position, 10 per
    search step, 10 per candidate, 6 per compared byte."""
    n, L = lanes["codes"].shape
    steps = int(meta[:, 3].sum())
    side = (pos_bytes - 4) * work["seeds"] if "buckets" in work else 0
    nbytes = (n * (5 * L + 4 + 16) + seed_bytes(work, pos_bytes)
              + pos_bytes * work["candidates"] + work["text_bytes"]
              + (4 + pos_bytes) * work["stored"] + side + n * M * C * 9
              + extra_bytes)
    nops = (40 * steps + 10 * work.get("search_steps", 0)
            + 10 * work["candidates"] + 6 * work["text_bytes"])
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
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda as scan
    from sailfish_tpu_torch.map.scan import mmp_scan_reference

    # the route of the index: its k-mer table, or its prefix table
    reads_what = ("lookups + search steps" if tidx.prefix_route
                  else "table rows")
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
        k = scan(lanes, tidx, out=bufs, **kw)
        p = mmp_scan_reference(lanes, tidx, work=work, **kw)
        torch.cuda.synchronize()
        err = _same_raw(torch, name, k, p, PLAIN)
        ks = intersect_sort(*k[:3], k[3][:, 0], C=C, M=4)
        ps = intersect_sort(*p[:3], p[3][:, 0], C=C, M=4)
        require(all(torch.equal(x, y) for x, y in zip(ks, ps)),
                f"{name}: kernel and plain version differ after the "
                "post-pass")
        mapped = int((ps[2].sum(1) > 0).sum())
        del ks, ps, p, bufs
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        scan(lanes, tidx, rows_read=rows, **kw)
        rows = int(rows.item())
        need = seed_reads(work)
        require(rows >= need, f"{name}: the kernel read {rows} "
                f"{reads_what}, fewer than the {need} the scan needs")
        chunks, chunks_say = ({}, "") if not tidx.prefix_route else (
            chunk_count(torch, lambda n: scan(lanes, tidx, chunks_read=n,
                                              **kw), work, name))
        ms = _time_ms(torch, lambda: scan(lanes, tidx, **kw), 5)
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
            f"probed positions {int(k[3][:, 3].sum())}, {reads_what} "
            f"needed {need}, read by the kernel {rows} "
            f"({rows / max(need, 1):.4f}x), candidates "
            f"{work['candidates']} ({work['stored']} stored), text "
            f"bytes {work['text_bytes']}"
            f"{', ' + chunks_say if chunks_say else ''}; kernel "
            f"{ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']} at the published peak "
            f"({bound['bound_ms'] * PEAK_BYTES_S / copy_rate:.4f} ms at "
            f"the measured copy rate), kernel / bound "
            f"{ms / bound['bound_ms']:.2f} [{card}]")
        out[name] = {
            "lanes": n_lanes, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err, "table_rows_needed": need,
            "table_rows_read": rows, **chunks, **bound}
        del k
        torch.cuda.empty_cache()
    return out


def big_index(index):
    """The 64-bit (big_sa) layout of a 32-bit index, as
    `build_index(force_big_sa=True)` gives it: the same suffix array,
    k-mer table (where it has one) and prefix table, in int64."""
    import dataclasses

    ht = index.kmer_ht
    return dataclasses.replace(
        index, sa=index.sa.astype(np.int64),
        table_lo=index.table_lo.astype(np.int64),
        kmer_ht=None if ht is None else {
            **ht, "ht_lo": ht["ht_lo"].astype(np.int64)})


def _ff_outputs(torch, n_lanes, C, dev):
    """The scan's four output buffers, filled with 0xFF bytes."""
    return tuple(
        torch.full(shape, fill, dtype=dt, device=dev)
        for shape, fill, dt in (
            ((n_lanes, 4 * C), -1, torch.int32),
            ((n_lanes, 4 * C), -1, torch.int32),
            ((n_lanes, 4 * C), 255, torch.uint8),
            ((n_lanes, 4), -1, torch.int32)))


def _same_raw(torch, name, got, want, what,
              outs=("txp", "pos", "valid", "meta")):
    """Each of the outputs `outs` of the kernel (`got`) equal to `want`'s
    bit for bit (valid as bytes: a slot still 0xFF must not pass for
    True); returns the max abs diff, 0."""
    err = 0
    for out, a, b in zip(outs, got, want):
        a = a.view(torch.uint8) if a.dtype == torch.bool else a
        b = b.view(torch.uint8) if b.dtype == torch.bool else b
        require(a.shape == b.shape, f"{name}: `{out}` shapes differ")
        d = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        require(d == 0, f"{name}: raw `{out}` of the kernel differs from "
                f"{what} in {int((a.long() != b.long()).sum())} places "
                f"(max abs diff {d})")
        err = max(err, d)
    return err


def phase_kernel64(torch, tidx, tidx64, blocks, card, copy_rate):
    """The 64-bit instantiation of the scan (`sf_mmp_scan64`, on the
    big_sa layout of the world's index) against its plain version and
    against the 32-bit instantiation on the same lanes: all four raw
    outputs bit for bit, written over 0xFF.  Timed in turns with the
    32-bit instantiation (32, 64, 64, 32).  `blocks` are (tag, reads,
    cases) as phase 4 takes them.  Returns {name: readings}."""
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda, mmp_scan_reference

    dev = tidx64.device
    idx = {32: tidx, 64: tidx64}
    out = {}
    for tag, (codes, lens, what), cases in blocks:
        L = codes.shape[1]
        lanes = make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                    torch.from_numpy(lens).to(dev))
        n_lanes = lanes["codes"].shape[0]
        for case in cases:
            C = case["cand_cap"]
            kw = {"max_mmps": 4, "max_steps": L, "skip_jump": False, **case}
            name = f"{tag}_L{L}_C{C}"
            k64 = mmp_scan_cuda(lanes, tidx64,
                                out=_ff_outputs(torch, n_lanes, C, dev), **kw)
            k32 = mmp_scan_cuda(lanes, tidx, **kw)
            work = {}
            p = mmp_scan_reference(lanes, tidx64, work=work, **kw)
            torch.cuda.synchronize()
            err = max(_same_raw(torch, name, k64, p, "its plain version"),
                      _same_raw(torch, name, k64, k32,
                                "the 32-bit instantiation's"))
            t = {32: [], 64: []}
            for bits in (32, 64, 64, 32):
                t[bits].append(_time_ms(
                    torch, lambda: mmp_scan_cuda(lanes, idx[bits], **kw), 5))
            ms = {b: sum(v) / len(v) for b, v in t.items()}
            plain_ms = _time_ms(
                torch, lambda: mmp_scan_reference(lanes, tidx64, **kw), 1)
            chunks, chunks_say = ({}, "") if not tidx64.prefix_route else (
                chunk_count(torch, lambda n: mmp_scan_cuda(
                    lanes, tidx64, chunks_read=n, **kw), work, name))
            bound = scan_bound(lanes, k64[3], work, C, 4, pos_bytes=8)
            at_copy = bound["bound_ms"] * PEAK_BYTES_S / copy_rate
            say(f"kernel 64-bit vs plain {name}: {n_lanes} lanes ({what} x "
                f"fwd/rc), all four raw outputs equal to the plain "
                f"version's and to the 32-bit instantiation's, written over "
                f"0xFF; seeds {work['seeds']}"
                f"{'' if tidx64.prefix_route else ' (a side-array word each)'}"
                f", "
                f"candidates {work['candidates']} ({work['stored']} "
                f"stored){', ' + chunks_say if chunks_say else ''}; "
                f"64-bit {ms[64]:.3f} ms ({t[64][0]:.3f}, "
                f"{t[64][1]:.3f}), 32-bit {ms[32]:.3f} ms ({t[32][0]:.3f}, "
                f"{t[32][1]:.3f}), 64 / 32 {ms[64] / ms[32]:.3f}; plain "
                f"{plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms by "
                f"{bound['bound_by']} ({at_copy:.4f} ms at the measured "
                f"copy rate), 64-bit / bound "
                f"{ms[64] / bound['bound_ms']:.2f} [{card}]")
            out[name] = {"lanes": n_lanes, "ms": ms[64], "ms_int32": ms[32],
                         "plain_ms": plain_ms, "max_abs_err": err,
                         "seeds": work["seeds"], **chunks, **bound}
            del k64, k32, p
        del lanes
        torch.cuda.empty_cache()
    return out


def phase_shifted(torch, index, tidx64, reads, card):
    """Positions and suffix-array indices above 2^31 and 2^32 on the
    card, which a 64-bit index of the world's size never reaches.  First
    a shifted copy of the 64-bit index: 2^31 bytes of code 4 in front of
    the text, 2^31 entries in front of `txp_of_pos` and of the suffix
    array, every suffix-array entry, transcript offset and table `lo`
    + 2^31.  Then 2^32 further, with no copy: the text, `txp_of_pos` and
    suffix-array base pointers handed to `sf_mmp_scan64` are moved back
    by that many entries, and every entry, offset and `lo` (now with a
    high word of 1) moved forward.  The kernel's four raw outputs on the
    lanes of `reads` must equal the unshifted run's, bit for bit."""
    import dataclasses

    from sailfish_tpu_torch import _ext
    from sailfish_tpu_torch.index.device import fused_table
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda

    codes, lens, what = reads
    dev = tidx64.device
    L = codes.shape[1]
    lanes = make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                torch.from_numpy(lens).to(dev))
    n_lanes = lanes["codes"].shape[0]
    kw = dict(cand_cap=64, max_mmps=4, max_steps=L, skip_jump=False)
    want = mmp_scan_cuda(lanes, tidx64, **kw)
    ht = index.kmer_ht

    def table(shift):
        return (torch.from_numpy(t).to(dev) for t in fused_table(
            ht["ht_key0"], ht["ht_key1"],
            ht["ht_lo"].astype(np.int64) + shift, ht["ht_cnt"], 64))

    S = 1 << 31
    n = tidx64.n_text
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    text = torch.full((S + tidx64.codes.numel(),), 4, dtype=torch.uint8,
                      device=dev)
    text[S:] = tidx64.codes
    tpos = torch.zeros(S + n, dtype=torch.int32, device=dev)
    tpos[S:] = tidx64.txp_of_pos
    sa = torch.zeros(S + n, dtype=torch.int64, device=dev)
    sa[S:] = tidx64.sa + S
    ht2, hi2 = table(S)
    shifted = dataclasses.replace(
        tidx64, n_text=S + n, codes=text, sa=sa, ht=ht2, ht_hi=hi2,
        txp_of_pos=tpos, txp_offsets=tidx64.txp_offsets + S)
    got = mmp_scan_cuda(lanes, shifted,
                        out=_ff_outputs(torch, n_lanes, 64, dev), **kw)
    torch.cuda.synchronize()
    _same_raw(torch, "shifted by 2^31", got, want, "the unshifted run's")
    peak = torch.cuda.max_memory_allocated() / 2**30
    lo_max = int(ht["ht_lo"].max()) + S
    say(f"kernel 64-bit shifted by 2^31: {n_lanes} lanes ({what} x fwd/rc) "
        f"on a copy with {S + n} text positions and suffix-array entries "
        f"(table lo up to {lo_max}, positions up to {S + n - 1}): all four "
        f"raw outputs equal to the unshifted run's, written over 0xFF; "
        f"peak {peak:.3f} GiB allocated, {time.time() - t0:.1f}s [{card}]")
    del shifted, text, tpos, sa, ht2, hi2, got
    torch.cuda.empty_cache()

    T = S + (1 << 32)
    ht3, hi3 = table(T)
    sa3 = tidx64.sa + T
    offs3 = tidx64.txp_offsets + T
    outs = _ff_outputs(torch, n_lanes, 64, dev)
    lc, lp, ll = (lanes[k].contiguous() for k in ("codes", "pw", "lens"))
    require(all(x.data_ptr() % 16 == 0 for x in (lc, lp, ll)),
            "lane rows are not 16-byte aligned")
    kl = _ext.load()
    err = kl.lib.sf_mmp_scan64(
        lc.data_ptr(), lp.data_ptr(), ll.data_ptr(), n_lanes, L,
        tidx64.codes.data_ptr() - T, tidx64.codes.numel() + T,
        sa3.data_ptr() - 8 * T, ht3.data_ptr(), hi3.data_ptr(),
        tidx64.txp_of_pos.data_ptr() - 4 * T, offs3.data_ptr(), tidx64.k,
        64, 4, L, tidx64.ht_bits, tidx64.ht_probes, 0,
        *(o.data_ptr() for o in outs), None, None, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    kl.check(err, "the 64-bit scan with moved base pointers")
    torch.cuda.synchronize()
    _same_raw(torch, "shifted by 2^31 + 2^32", outs, want,
              "the unshifted run's")
    say(f"kernel 64-bit shifted by 2^31 + 2^32 through moved base pointers: "
        f"{n_lanes} lanes, table lo up to {int(ht['ht_lo'].max()) + T} (high "
        f"word {T >> 32}), positions up to {T + n - 1}: all four raw outputs "
        f"equal to the unshifted run's [{card}]")
    del ht3, hi3, sa3, offs3, outs, want, lanes
    torch.cuda.empty_cache()


def prefix_index(index):
    """The world's index without a k-mer table, at k = PREFIX_K: the
    k = 31 index's text and suffix array (which do not depend on k), with
    the packed words, separator distances and prefix table recomputed by
    `QuasiIndex.from_arrays`; no second suffix-array build."""
    from sailfish_tpu_torch.index.builder import QuasiIndex

    return QuasiIndex.from_arrays(
        k=PREFIX_K, names=index.names, codes=index.codes, sa=index.sa,
        txp_of_pos=index.txp_of_pos, txp_offsets=index.txp_offsets,
        txp_lens=index.txp_lens, kmer_ht=None)


def run_modes(torch, shards, lanes, name, C=64, M=4, timed=False):
    """The sharded scan's modes on `lanes` (on the first shard's card),
    each kernel against its plain version on the same inputs, bit for
    bit: the facts pass (both passes on the prefix route) on every shard;
    the replay, on the k-mer route in shards mode (the merge inside the
    kernel; the main path's) and in plane mode over the torch merge's
    facts, on the prefix route in plane mode after the torch merge; the
    slots on every shard.  Returns (hits, hit_len, meta, level, [(txp,
    pos, valid) per shard], readings): readings[kernel] holds one dict a
    launch (facts: a shard and pass; slots: a shard; "replay": the plane
    mode, "replay_shards": the shards mode) with its "max_abs_err" and
    the plain version's `work`, a facts launch also its "chunks_read" and
    "chunks_needed" (`chunk_count`) and "chunks_say" (its phrase); with
    `timed`, also the kernel's "ms" (mean of 3; the replay's queued,
    `_time_ms`) and the plain version's "plain_ms" (1 call) on those
    inputs, and the shards mode the torch merge's "merge_ms" (mean of 3,
    queued), which the plane mode needs first."""
    from sailfish_tpu_torch.map.facts import (
        FactsMerge,
        facts_cuda,
        facts_reference,
        replay_cuda,
        replay_reference,
        replay_shards_cuda,
        replay_shards_reference,
        slots_cuda,
        slots_reference,
    )

    readings = {"facts": [], "replay": [], "replay_shards": [], "slots": []}

    def held(kernel, what, outs, kern, plain, counted=None):
        """kern() against plain(work); `counted(n)`, when given, launches
        the kernel with a chunk counter.  Returns the kernel's outputs."""
        def tup(x):
            return x if isinstance(x, tuple) else (x,)

        work = {}
        got = kern()
        r = {"max_abs_err": _same_raw(torch, f"{name} {what}", tup(got),
                                      tup(plain(work)), PLAIN, outs),
             "work": work}
        if counted is not None:
            c, r["chunks_say"] = chunk_count(torch, counted, work,
                                             f"{name} {what}")
            r.update(c)
        if timed:
            r["ms"] = _time_ms(torch, kern, 3,
                               queued=kernel.startswith("replay"))
            r["plain_ms"] = _time_ms(torch, lambda: plain(None), 1)
        readings[kernel].append(r)
        return got

    L = lanes["codes"].shape[1]
    lens = lanes["lens"]
    merge = FactsMerge(k=shards.k, cand_cap=C, prefix=shards.prefix_route)
    fl = []
    for d, ix in enumerate(shards.indexes):
        fl.append(held(
            "facts", f"facts, shard {d}", ("facts",),
            lambda: facts_cuda(lanes, ix, cand_cap=C),
            lambda w: facts_reference(lanes, ix, cand_cap=C, work=w),
            lambda n: facts_cuda(lanes, ix, cand_cap=C, chunks_read=n)))
        merge.add(fl[-1])
    level = None
    if shards.prefix_route:
        level = merge.levels()
        for d, ix in enumerate(shards.indexes):
            merge.add_lcp(held(
                "facts", f"facts at the levels, shard {d}", ("facts",),
                lambda: facts_cuda(lanes, ix, cand_cap=C, level=level),
                lambda w: facts_reference(lanes, ix, cand_cap=C,
                                          level=level, work=w),
                lambda n: facts_cuda(lanes, ix, cand_cap=C, level=level,
                                     chunks_read=n)))
        fl = []
    gfact = merge.gfact()
    del merge
    kw = dict(k=shards.k, max_mmps=M, max_steps=L, skip_jump=False)
    outs = ("hits", "hit_len", "meta")
    r = held("replay", "replay, plane mode", outs,
             lambda: replay_cuda(gfact, lens, **kw),
             lambda w: replay_reference(gfact, lens, work=w, **kw))
    del gfact
    if fl:
        r = held("replay_shards", "replay, shards mode", outs,
                 lambda: replay_shards_cuda(fl, lens, cand_cap=C, **kw),
                 lambda w: replay_shards_reference(fl, lens, cand_cap=C,
                                                   work=w, **kw))
        if timed:
            def torch_merge():
                m = FactsMerge(k=shards.k, cand_cap=C, prefix=False)
                for f in fl:
                    m.add(f)
                return m.gfact()
            readings["replay_shards"][-1]["merge_ms"] = _time_ms(
                torch, torch_merge, 3, queued=True)
    del fl
    slots = []
    for d, (ix, base) in enumerate(zip(shards.indexes, shards.bases)):
        skw = dict(txp_base=base, cand_cap=C, max_mmps=M)
        slots.append(held(
            "slots", f"slots, shard {d}", ("txp", "pos", "valid"),
            lambda: slots_cuda(lanes, ix, *r, level, **skw),
            lambda w: slots_reference(lanes, ix, *r, level, work=w,
                                      **skw)))
    return (*r, level, slots, readings)


def mode_errs(*readings):
    """The largest error of each kernel over `readings` (run_modes');
    None for a kernel that none of them launched."""
    return {k: max((x["max_abs_err"] for rd in readings for x in rd[k]),
                   default=None)
            for k in ("facts", "replay", "replay_shards", "slots")}


def phase_modes_one_shard(torch, tidx, reads, card):
    """The modes on `tidx` as one shard (on the prefix route both facts
    passes), each against its plain version, and their slots and meta
    against the scan's raw outputs on the same index, bit for bit.
    Returns run_modes' readings."""
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda
    from sailfish_tpu_torch.parallel.shardidx import TorchShards

    codes, lens, what = reads
    dev = tidx.device
    lanes = make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                torch.from_numpy(lens).to(dev))
    L = codes.shape[1]
    t0 = time.time()
    route = "prefix" if tidx.prefix_route else "k-mer"
    name = f"{route} modes, {tidx.pos_bits}-bit"
    hits, hit_len, meta, level, slots, readings = run_modes(
        torch, TorchShards([tidx], [0]), lanes, name)
    scan = mmp_scan_cuda(lanes, tidx, cand_cap=64, max_mmps=4, max_steps=L)
    torch.cuda.synchronize()
    _same_raw(torch, name, (*slots[0], meta), scan,
              f"the {route} scan's raw outputs")
    levels = ("" if level is None else
              f"levels refined at depth 0 {int(((level & 1) != 0).sum())}, "
              f"at depth 16 {int(((level & 2) != 0).sum())}; ")
    say(f"modes on the k = {tidx.k} {tidx.pos_bits}-bit index as one shard "
        f"({route} route): {lanes['codes'].shape[0]} lanes ({what} x "
        f"fwd/rc, an N in every 7th read), C = 64: the facts pass"
        f"{'es' if level is not None else ''}, the replay and the slots "
        f"equal to their plain versions, and slots and meta equal to the "
        f"scan's raw outputs; {levels}{int(meta[:, 0].sum())} MMPs, "
        f"{int(meta[:, 1].sum())} overflowed lanes ({time.time() - t0:.1f}s)"
        f" [{card}]")
    return readings


def prefix_shards(sidx, P, device):
    """The shards of `sidx` (the world's k = 31 sharded index) at
    k = PREFIX_K with a prefix table of P bases: what `index -k 15
    --indexShards 4 --prefixBases P` builds, from the shards' own text
    and suffix arrays (which do not depend on k), with no second
    suffix-array build.  Returns TorchShards on `device`."""
    from sailfish_tpu_torch.index.builder import QuasiIndex
    from sailfish_tpu_torch.index.device import TorchIndex
    from sailfish_tpu_torch.parallel.shardidx import TorchShards

    return TorchShards(
        indexes=[TorchIndex.from_quasi_index(QuasiIndex.from_arrays(
            k=PREFIX_K, names=s.names, codes=s.codes, sa=s.sa,
            txp_of_pos=s.txp_of_pos, txp_offsets=s.txp_offsets,
            txp_lens=s.txp_lens, kmer_ht=None, prefix_bases=P), device)
            for s in sidx.shards],
        bases=[int(lo) for lo, _ in sidx.ranges])


def same_map(torch, got, want, what):
    """The sharded map's hits equal the monolithic map's: each lane's
    valid slots in order, mlen, overflow and the mapped-loci count (the
    monolithic post-pass leaves a hole where it drops a transcript's
    second locus; the sharded map's compaction does not)."""
    va, vb = got["valid"], want["valid"]
    require(torch.equal(va.sum(1), vb.sum(1))
            and torch.equal(got["txp"][va], want["txp"][vb])
            and torch.equal(got["pos"][va], want["pos"][vb])
            and all(torch.equal(got[f], want[f])
                    for f in ("mlen", "overflow", "num_mapped_loci")),
            f"the sharded map of {what} differs from the monolithic map")


def phase_prefix_sharded(torch, tidx15, sidx, batch, sample_reads, card):
    """The k = 15 index in SHARDS shards (`prefix_shards`, the prefix
    table as wide as the monolithic k = 15 index's): the modes against
    their plain versions on the sample at C = 64 and C = 2 (the global
    sizes merged across shards, the levels chosen from them, the second
    facts pass at those levels); the sharded map of the paired batch
    against the monolithic k = 15 map, bit for bit, launching the
    replay's plane mode once and its shards mode never.  Returns
    ([run_modes' readings], the map's launch counts)."""
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.lanes import map_oriented_lanes
    from sailfish_tpu_torch.parallel.shardidx import (
        map_oriented_lanes_sharded,
    )

    dev = tidx15.device
    t0 = time.time()
    shards = prefix_shards(sidx, tidx15.prefix_bases, dev)
    say(f"k = {PREFIX_K} index in {SHARDS} shards (from the sharded "
        f"index's arrays, P = {tidx15.prefix_bases}): "
        f"{[ix.n_text for ix in shards.indexes]} text positions "
        f"({time.time() - t0:.1f}s)")
    codes, lens, what = sample_reads
    lanes = make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                torch.from_numpy(lens).to(dev))
    readings = []
    for C in (64, 2):
        t0 = time.time()
        *_, meta, level, _, rd = run_modes(
            torch, shards, lanes, f"k = {PREFIX_K} sharded, C = {C}", C=C)
        readings.append(rd)
        torch.cuda.synchronize()
        say(f"modes on the k = {PREFIX_K} {SHARDS}-shard index: "
            f"{lanes['codes'].shape[0]} lanes ({what} x fwd/rc, an N in "
            f"every 7th read), C = {C}: the sizes pass on each shard, the "
            f"levels from the merged sizes (refined at depth 0 "
            f"{int(((level & 1) != 0).sum())}, at depth 16 "
            f"{int(((level & 2) != 0).sum())}), the pass at the levels on "
            f"each shard, the replay and the slots on each shard equal to "
            f"their plain versions; {int(meta[:, 0].sum())} MMPs, "
            f"{int(meta[:, 1].sum())} overflowed lanes "
            f"({time.time() - t0:.1f}s) [{card}]")
    del lanes
    codes, lens, what = _mate_reads(batch, False)
    codes = torch.from_numpy(codes).to(dev)
    lens = torch.from_numpy(lens).to(dev)
    kw = dict(cand_cap=64, max_mmps=4, max_steps=codes.shape[1])
    t0 = time.time()
    _launch_counts(reset=True)
    got = map_oriented_lanes_sharded(shards, codes, lens, **kw)
    n = _launch_counts()
    require(n["mmp_replay"] == 1 and n["mmp_replay_shards"] == 0
            and n["mmp_facts"] == 2 * SHARDS and n["mmp_slots"] == SHARDS,
            f"the sharded map at k = {PREFIX_K} launched {n}")
    want = map_oriented_lanes(tidx15, codes, lens, **kw)
    same_map(torch, got, want, f"the paired batch at k = {PREFIX_K}")
    say(f"sharded map of the paired batch at k = {PREFIX_K} "
        f"({2 * codes.shape[0]} lanes, C = 64, {SHARDS} shards): each "
        f"lane's valid slots in order, mlen and overflow equal to the "
        f"monolithic k = {PREFIX_K} map's bit for bit; launches facts "
        f"{n['mmp_facts']}, replay {n['mmp_replay']} (plane mode), slots "
        f"{n['mmp_slots']}; {int(want['overflow'].sum())} overflowed lanes "
        f"({time.time() - t0:.1f}s) [{card}]")
    del got, want, shards
    torch.cuda.empty_cache()
    return readings, n


def facts_bound(lanes, work, pos_bytes, k):
    """Least time for one facts pass (k-mer route) on these inputs: per
    lane 5 L bytes of rows and its length, the seeds' reads, a
    suffix-array entry and the compared text bytes per candidate, and 8
    bytes of facts per position written.  Operations: about 40 per probed
    position, 10 per candidate, 6 per compared byte."""
    n, L = lanes["codes"].shape
    positions = int((lanes["lens"].long() - k + 1).clamp(min=0).sum())
    nbytes = (n * (5 * L + 4) + seed_bytes(work, pos_bytes)
              + pos_bytes * work["candidates"] + work["text_bytes"]
              + 8 * n * L)
    return bound_ms(nbytes, 40 * positions + 10 * work["candidates"]
                    + 6 * work["text_bytes"]), positions


def phase_sharded_kernels(torch, index, tidx, shards, batch, sample_reads,
                          card, copy_rate):
    """The sharded index on the card.  The modes against their plain
    versions, bit for bit (facts and slots on every shard, the replay on
    the merged facts): on a sample at C = 64, on an escalation chunk (the
    batch's first `_ESC_ROWS` fragments with a lane that overflows at
    C = 64, filled up with others) at C = 1024, and on the paired batch's
    lanes at C = 64, where each launch is also timed beside its plain
    version and its bound.  The sharded map against the monolithic map,
    bit for bit (compacted slots, mlen, overflow), on the paired batch
    (both timed in turns) and on the escalation chunk; and the device
    half of a batch (`map_prefetched`: lanes, map, merge,
    collapse, counters) of the two backends in turns, each closed by a
    synchronize.  `batch` is the paired batch's (m1, m2).  Returns
    ({kernel: readings}, [run_modes' readings])."""
    from sailfish_tpu_torch.bench import fastq_batch
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend
    from sailfish_tpu_torch.map.sharded import ShardedMapperBackend
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.lanes import map_oriented_lanes
    from sailfish_tpu_torch.parallel.shardidx import (
        map_oriented_lanes_sharded,
    )

    dev = shards.device
    D = len(shards.indexes)

    def lanes_of(reads):
        codes, lens, _ = reads
        return (torch.from_numpy(codes).to(dev),
                torch.from_numpy(lens).to(dev))

    t0 = time.time()
    sc, sl = lanes_of(sample_reads)
    *_, meta, _, _, rd_sample = run_modes(
        torch, shards, make_oriented_lanes(sc, sl), "sharded")
    torch.cuda.synchronize()
    say(f"modes on the {D}-shard index: {2 * sc.shape[0]} lanes "
        f"({sample_reads[2]} x fwd/rc, an N in every 7th read), C = 64: "
        f"facts on each shard, replay, slots on each shard equal to their "
        f"plain versions; {int(meta[:, 0].sum())} MMPs "
        f"({time.time() - t0:.1f}s) [{card}]")

    codes, lens = lanes_of(_mate_reads(batch, False))
    L = codes.shape[1]
    kw = dict(cand_cap=64, max_mmps=4, max_steps=L)
    got = map_oriented_lanes_sharded(shards, codes, lens, **kw)
    want = map_oriented_lanes(tidx, codes, lens, **kw)
    same_map(torch, got, want, "the paired batch")
    # the escalation chunk: fragments with a lane that overflowed
    nf = batch[0].shape[0]
    over = want["overflow"].view(4, nf).any(0).cpu().numpy()
    rows = DeviceMapperBackend._ESC_ROWS
    pick = np.concatenate([np.flatnonzero(over),
                           np.flatnonzero(~over)])[:rows]
    del got, want
    t = {"mono": [], "sharded": []}
    for which in ("mono", "sharded", "sharded", "mono"):
        fn = ((lambda: map_oriented_lanes(tidx, codes, lens, **kw))
              if which == "mono" else
              (lambda: map_oriented_lanes_sharded(shards, codes, lens,
                                                  **kw)))
        t[which].append(_time_ms(torch, fn, 2))
    ms = {w: sum(v) / len(v) for w, v in t.items()}
    n_lanes = 2 * codes.shape[0]
    say(f"sharded map of the paired batch ({n_lanes} lanes, L = {L}, "
        f"C = 64, {D} shards on the card): each lane's valid slots in "
        f"order, mlen and overflow equal to the monolithic map's bit for "
        f"bit; "
        f"lanes to post-passed hits {ms['sharded']:.3f} ms "
        f"({t['sharded'][0]:.3f}, {t['sharded'][1]:.3f}) against "
        f"{ms['mono']:.3f} ms monolithic ({t['mono'][0]:.3f}, "
        f"{t['mono'][1]:.3f}), {ms['sharded'] / ms['mono']:.2f}x [{card}]")

    t0 = time.time()
    ec, el = lanes_of(_mate_reads(tuple(m[pick] for m in batch), False))
    ekw = dict(kw, cand_cap=1024)
    *_, meta, _, _, rd_esc = run_modes(
        torch, shards, make_oriented_lanes(ec, el), "sharded escalation",
        C=1024)
    same_map(torch, map_oriented_lanes_sharded(shards, ec, el, **ekw),
             map_oriented_lanes(tidx, ec, el, **ekw), "an escalation chunk")
    torch.cuda.synchronize()
    say(f"escalation chunk on the {D}-shard index: {rows} fragments "
        f"({int(over.sum())} of the batch's {nf} with a lane that "
        f"overflows at C = 64, first), {4 * rows} lanes, C = 1024: facts "
        f"on each shard, replay, slots on each shard equal to their plain "
        f"versions, the sharded map equal to the monolithic one; "
        f"{int(meta[:, 0].sum())} MMPs, {int(meta[:, 1].sum())} lanes "
        f"still overflowing ({time.time() - t0:.1f}s) [{card}]")
    del ec, el

    opts = QuantOpts(hit_capacity=64, hit_capacity_max=1024)
    bes = {"mono": DeviceMapperBackend(index, opts, dev, tindex=tidx),
           "sharded": ShardedMapperBackend(None, opts, [dev],
                                           shards=shards)}
    pf = bes["mono"].prefetch_pe(*(fastq_batch(m) for m in batch))
    exp = parse_library_format("IU")
    for be in bes.values():  # a first call of each, untimed
        be.map_prefetched(pf, exp)
    tb = {"mono": [], "sharded": []}
    for which in ("mono", "sharded", "sharded", "mono"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bes[which].map_prefetched(pf, exp)
        torch.cuda.synchronize()
        tb[which].append(1e3 * (time.perf_counter() - t0))
    say(f"map_prefetched of the paired batch ({codes.shape[0] // 2} "
        f"fragments; lanes, map, merge, collapse, counters; "
        f"synchronized, after a first call of each): sharded "
        f"{tb['sharded'][0]:.3f}, "
        f"{tb['sharded'][1]:.3f} ms against monolithic {tb['mono'][0]:.3f}, "
        f"{tb['mono'][1]:.3f} ms [{card}]")
    del bes, pf

    # the modes on the paired batch's lanes, every launch timed
    lanes = make_oriented_lanes(codes, lens)
    pos_bytes = [8 if ix.pos_bits == 64 else 4 for ix in shards.indexes]
    hits, _, meta, _, _, rd = run_modes(torch, shards, lanes,
                                        "sharded paired batch", timed=True)
    mmps = int(meta[:, 0].sum())
    steps = int(meta[:, 3].sum())
    for d, r in enumerate(rd["facts"]):
        w = r["work"]
        r["bound"], positions = facts_bound(lanes, w, pos_bytes[d],
                                            shards.k)
        say(f"facts kernel, shard {d} of {D}, paired batch: {n_lanes} "
            f"lanes, {positions} probed positions, {w['buckets']} table "
            f"rows, {w['candidates']} candidates, {w['text_bytes']} text "
            f"bytes, {8 * n_lanes * L} bytes of facts written, "
            f"{r['chunks_say']}; kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound']['bound_ms']:.4f} ms by {r['bound']['bound_by']} "
            f"({r['bound']['bound_ms'] * PEAK_BYTES_S / copy_rate:.4f} ms "
            f"at the measured copy rate), kernel / bound "
            f"{r['ms'] / r['bound']['bound_ms']:.2f}; equal to the plain "
            f"version [{card}]")
    # the replay's bound: the 32-byte sectors of the input rows that the
    # advance visits (the plain version's work["sectors"]: of the int32
    # plane, or of every shard's int2 row), each lane's length, its hits,
    # hit lengths and meta written; about 10 operations a position
    out_bytes = n_lanes * (4 + 8 * 4 + 16)
    for key, what in (("replay", "plane mode, over the torch merge's facts"),
                      ("replay_shards", f"shards mode, over the {D} shards' "
                       "facts")):
        r = rd[key][0]
        w = r["work"]
        r["bound"] = bound_ms(32 * w["sectors"] + out_bytes,
                              10 * w["positions"])
        words = bound_ms(4 * steps + out_bytes, 10 * steps)
        say(f"replay kernel, {what}, paired batch: {n_lanes} lanes, "
            f"{w['positions']} positions read in {w['sectors']} 32-byte "
            f"sectors, {mmps} MMPs; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound']['bound_ms']:.4f} ms "
            f"by {r['bound']['bound_by']} (counted at 4 bytes a position, "
            f"as before: {words['bound_ms']:.4f} ms), kernel / bound "
            f"{r['ms'] / r['bound']['bound_ms']:.2f}; equal to the plain "
            f"version [{card}]")
    rs, rp = rd["replay_shards"][0], rd["replay"][0]
    say(f"merge + replay, paired batch, {D} shards: the torch merge "
        f"{rs['merge_ms']:.4f} ms + the plane mode {rp['ms']:.4f} ms = "
        f"{rs['merge_ms'] + rp['ms']:.4f} ms against the shards mode "
        f"{rs['ms']:.4f} ms, "
        f"{rs['ms'] / (rs['merge_ms'] + rp['ms']):.3f}x [{card}]")
    for d, r in enumerate(rd["slots"]):
        w = r["work"]
        r["bound"] = bound_ms(
            n_lanes * (5 * L + 4 + 8 * 4 + 16) + seed_bytes(w, pos_bytes[d])
            + pos_bytes[d] * w["candidates"] + w["text_bytes"]
            + (4 + pos_bytes[d]) * w["stored"] + n_lanes * 4 * 64 * 9,
            40 * mmps + 10 * w["candidates"] + 6 * w["text_bytes"])
        say(f"slot kernel, shard {d} of {D}, paired batch: {mmps} MMPs, "
            f"{w['buckets']} table rows, {w['candidates']} candidates "
            f"({w['stored']} stored); kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound']['bound_ms']:.4f} ms "
            f"by {r['bound']['bound_by']}, kernel / bound "
            f"{r['ms'] / r['bound']['bound_ms']:.2f}; equal to the plain "
            f"version [{card}]")
    out = {}
    for key, launches in rd.items():
        # per launch: the mean over this batch's launches (one a shard
        # for facts and slots), each launch beside it
        n = len(launches)
        each = [{"ms": x["ms"], "plain_ms": x["plain_ms"], **x["bound"],
                 **{c: x[c] for c in ("chunks_read", "chunks_needed")
                    if c in x},
                 **{c: x["work"][c] for c in ("positions", "sectors")
                    if c in x["work"]}} for x in launches]
        out[key] = {
            "lanes": n_lanes,
            "ms": sum(x["ms"] for x in each) / n,
            "plain_ms": sum(x["plain_ms"] for x in each) / n,
            "bound_ms": sum(x["bound_ms"] for x in each) / n,
            "bound_by": max({x["bound_by"] for x in each},
                            key=[x["bound_by"] for x in each].count),
            "per_launch": each}
    out["replay_shards"]["merge_ms"] = rs["merge_ms"]
    out["map_ms"] = ms
    out["map_prefetched_ms"] = tb
    del lanes, hits, meta
    torch.cuda.empty_cache()
    return out, [rd_sample, rd_esc, rd]


def load_other(path, name):
    """The `sailfish_tpu_torch` package of another checkout at `path`
    (its kernels built from its own sources into its own `_build/`),
    imported as `name` beside this one: (_ext, map.scan, map.facts)."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(path), "sailfish_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.{m}")
                 for m in ("_ext", "map.scan", "map.facts"))


def phase_in_turns(torch, other, index, tidx, idx4_dir, batch, kf, card):
    """This tree's scan kernels against another checkout's (`--against`),
    each row timed in turns (other, this, this, other) on the same card
    tensors, with whether the two gave the same outputs: the k-mer scan
    on the paired batch under both skip rules, in 32 and 64 bits; the
    prefix route on the paired batch and on the sample at C = 64, 1024
    and 2, in 32 bits, and at C = 64 in 64 bits; the facts and slot
    kernels of each of the 4 shards on the paired batch's lanes; the
    k-mer route's merge and replay (this tree's shards mode against the
    other's torch merge and replay), the replay's plane mode over the
    k-mer route's merged facts and over the prefix route's (the k = 15
    index in 4 shards); and, timed alone on the other tree's code, the
    k-mer route's torch merge, its replay, and the prefix route's merge
    after the sizes pass."""
    from sailfish_tpu_torch import _ext
    from sailfish_tpu_torch.index.builder import load_index
    from sailfish_tpu_torch.index.device import TorchIndex
    from sailfish_tpu_torch.map import facts, scan
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.parallel.shardidx import TorchShards

    o_ext, o_scan, o_facts = other
    dev = tidx.device
    t0 = time.time()
    kl, ko = _ext.load(), o_ext.load()
    say(f"in turns: this tree's kernels ({kl.path}) against "
        f"{ko.path} ({time.time() - t0:.1f}s to build) [{card}]")

    def lanes_of(reads):
        codes, lens, _ = reads
        return make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                   torch.from_numpy(lens).to(dev))

    def row(name, mine, theirs, reps=5, queued=False):
        a, b = mine(), theirs()
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        del a, b
        t = {"this": [], "other": []}
        for who in ("other", "this", "this", "other"):
            t[who].append(_time_ms(torch, mine if who == "this" else theirs,
                                   reps, queued))
        ms = {w: sum(v) / len(v) for w, v in t.items()}
        say(f"in turns {name}: this {ms['this']:.4f} ms ({t['this'][0]:.4f}"
            f", {t['this'][1]:.4f}), other {ms['other']:.4f} ms "
            f"({t['other'][0]:.4f}, {t['other'][1]:.4f}), this / other "
            f"{ms['this'] / ms['other']:.3f}; outputs "
            f"{'equal' if same else 'DIFFER'} [{card}]")

    paired = lanes_of(_mate_reads(batch, False))
    sample = lanes_of(_mate_reads(tuple(m[:kf] for m in batch), True))
    L = paired["codes"].shape[1]
    kw = dict(max_mmps=4, max_steps=L)
    tidx64 = TorchIndex.from_quasi_index(big_index(index), "cuda")
    for name, ix, extra in (("scan paired_batch C64", tidx, {}),
                            ("scan paired_batch C64 jump", tidx,
                             {"skip_jump": True}),
                            ("scan64 paired_batch C64", tidx64, {})):
        row(name,
            lambda: scan.mmp_scan_cuda(paired, ix, cand_cap=64, **kw,
                                       **extra),
            lambda: o_scan.mmp_scan_cuda(paired, ix, cand_cap=64, **kw,
                                         **extra))
    del tidx64
    idx15 = prefix_index(index)
    for bits in (32, 64):
        ix = TorchIndex.from_quasi_index(
            idx15 if bits == 32 else big_index(idx15), "cuda")
        cases = ((("prefix paired_batch", paired, 64),) if bits == 32
                 else ()) + tuple(
            (f"prefix{'' if bits == 32 else '64'} sample", sample, C)
            for C in ((64, 1024, 2) if bits == 32 else (64,)))
        for name, lanes, C in cases:
            row(f"{name} C{C}",
                lambda: scan.mmp_scan_cuda(lanes, ix, cand_cap=C, **kw),
                lambda: o_scan.mmp_scan_cuda(lanes, ix, cand_cap=C, **kw),
                reps=3)
        del ix
        torch.cuda.empty_cache()
    sidx = load_index(idx4_dir)
    shards = TorchShards.from_sharded(sidx, ["cuda"])
    fl = []
    for d, ix in enumerate(shards.indexes):
        fl.append(facts.facts_cuda(paired, ix, cand_cap=64))
        row(f"facts shard {d} paired_batch C64",
            lambda: facts.facts_cuda(paired, ix, cand_cap=64),
            lambda: o_facts.facts_cuda(paired, ix, cand_cap=64), reps=3)
    rkw = dict(k=shards.k, **kw)
    lens = paired["lens"]

    def other_merge():
        m = o_facts.FactsMerge(k=shards.k, cand_cap=64, prefix=False)
        for f in fl:
            m.add(f)
        return m

    # the other tree's merge and replay alone (step 0 when it is the parent)
    gfact = other_merge().gfact()
    step0 = {"merge": _time_ms(torch, lambda: other_merge().gfact(), 3,
                               queued=True),
             "replay": _time_ms(torch, lambda: o_facts.replay_cuda(
                 gfact, lens, **rkw), 3, queued=True)}
    # a checkout with the shards mode runs it; an older one its torch
    # merge and its replay
    theirs = ((lambda: o_facts.replay_shards_cuda(fl, lens, cand_cap=64,
                                                  **rkw))
              if hasattr(o_facts, "replay_shards_cuda") else
              (lambda: o_facts.replay_cuda(other_merge().gfact(), lens,
                                           **rkw)))
    row("merge + replay k-mer paired_batch C64 (this: shards mode; other: "
        "its own; queued)",
        lambda: facts.replay_shards_cuda(fl, lens, cand_cap=64, **rkw),
        theirs, reps=3, queued=True)
    for queued in (True, False):
        row(f"replay plane mode k-mer paired_batch C64 "
            f"({'queued' if queued else 'host-paced'})",
            lambda: facts.replay_cuda(gfact, lens, **rkw),
            lambda: o_facts.replay_cuda(gfact, lens, **rkw), queued=queued)
    r = facts.replay_shards_cuda(fl, lens, cand_cap=64, **rkw)
    del fl, gfact
    for d, (ix, base) in enumerate(zip(shards.indexes, shards.bases)):
        skw = dict(txp_base=base, cand_cap=64, max_mmps=4)
        row(f"slots shard {d} paired_batch C64",
            lambda: facts.slots_cuda(paired, ix, *r, None, **skw),
            lambda: o_facts.slots_cuda(paired, ix, *r, None, **skw),
            reps=3)
    del shards, r
    torch.cuda.empty_cache()
    # the prefix route's merge (levels from the summed sizes, the second
    # pass's LCPs folded in) and the plane mode over it, on the k = 15
    # index in shards
    shards = prefix_shards(sidx, idx15.prefix_bases, dev)
    sizes = [facts.facts_cuda(paired, ix, cand_cap=64)
             for ix in shards.indexes]
    m = o_facts.FactsMerge(k=shards.k, cand_cap=64, prefix=True)
    for f in sizes:
        m.add(f)
    level = m.levels()
    lcps = [facts.facts_cuda(paired, ix, cand_cap=64, level=level)
            for ix in shards.indexes]
    reps, a = 3, []
    for _ in range(reps + 1):  # the first untimed
        m = o_facts.FactsMerge(k=shards.k, cand_cap=64, prefix=True)
        for f in sizes:
            m.add(f)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # queued, as `_time_ms`'s
        e0.record()
        m.levels()
        for f in lcps:
            m.add_lcp(f)
        g15 = m.gfact()
        e1.record()
        torch.cuda.synchronize()
        a.append(e0.elapsed_time(e1))
    step0["prefix_merge"] = sum(a[1:]) / reps
    pkw = dict(k=shards.k, **kw)
    row("replay plane mode prefix paired_batch C64 (k = 15, 4 shards; "
        "queued)",
        lambda: facts.replay_cuda(g15, lens, **pkw),
        lambda: o_facts.replay_cuda(g15, lens, **pkw), queued=True)
    say(f"step 0, the other tree's code on the paired batch, {len(sizes)} "
        f"shards, mean of {reps}, queued: (a) k-mer route FactsMerge.add x "
        f"{len(sizes)} + gfact() {step0['merge']:.4f} ms; (b) its replay on "
        f"that gfact {step0['replay']:.4f} ms; (a) + (b) "
        f"{step0['merge'] + step0['replay']:.4f} ms; (c) prefix route "
        f"levels() + add_lcp x {len(lcps)} + gfact() "
        f"{step0['prefix_merge']:.4f} ms [{card}]")
    del shards, sizes, lcps, m, level, g15, paired, sample
    torch.cuda.empty_cache()


_LAUNCH_BASE = {}


def _launch_counts(reset=False):
    """The launches of the scan's kernels, {name: count}, counted by the
    port as `launch.<name>` (trace.py) since the last call with
    `reset`."""
    from sailfish_tpu_torch import trace

    now = {k: trace.counter("launch." + k) for k in (
        "mmp_scan", "mmp_scan_prefix", "mmp_scan_stamped", "mmp_facts",
        "mmp_replay", "mmp_replay_shards", "mmp_slots")}
    if reset:
        _LAUNCH_BASE.update(now)
    return {k: v - _LAUNCH_BASE.get(k, 0) for k, v in now.items()}


def phase_prefix_cli(torch, cli, wdir, idx15_dir, mates, card):
    """`quant -l IU --dumpEq` on the k = 15 index directory through the
    CLI, on the device backend and on `--backend refimpl` (the oracle),
    over the oracle sample: eq_classes.txt identical, quant.sf equal at
    rtol 1e-9, the prefix kernel launched by the device run only.
    Returns the device run's launch counts."""
    paths = [os.path.join(wdir, f"reads_prefix_{i}.fq") for i in (1, 2)]
    for path, m in zip(paths, mates):
        write_fastq(path, m)
    outs, launches, secs = {}, {}, {}
    for backend in ("device", "refimpl"):
        outs[backend] = os.path.join(wdir, f"quant_prefix_{backend}")
        shutil.rmtree(outs[backend], ignore_errors=True)
        _launch_counts(reset=True)
        t0 = time.time()
        rc = cli.main(["quant", "-i", idx15_dir, "-l", "IU", "-1", paths[0],
                       "-2", paths[1], "-o", outs[backend], "--hitCapacity",
                       "64", "--hitCapacityMax", "1024", "--dumpEq",
                       "--backend", backend])
        secs[backend] = time.time() - t0
        launches[backend] = _launch_counts()
        require(rc == 0, f"quant on the k = {PREFIX_K} index ({backend}) "
                f"exited {rc}")
    dl, rl = launches["device"], launches["refimpl"]
    require(dl["mmp_scan_prefix"] > 0 and dl["mmp_scan"] == 0,
            f"quant on the k = {PREFIX_K} index launched {dl}")
    require(not any(rl.values()), f"the refimpl run launched {rl}")
    eq = [open(os.path.join(o, "aux", "eq_classes.txt")).read()
          for o in outs.values()]
    require(eq[0] == eq[1], f"quant on the k = {PREFIX_K} index: "
            "eq_classes.txt differs from the refimpl backend's")
    got, want = (_quant_sf(o) for o in outs.values())
    require(np.allclose(got, want, rtol=1e-9, atol=0),
            f"quant on the k = {PREFIX_K} index: quant.sf differs from the "
            "refimpl backend's beyond rtol 1e-9")
    with open(os.path.join(outs["device"], "aux", "meta_info.json")) as fh:
        meta = json.load(fh)
    require(meta["quant_timings"]["device"].startswith("cuda"),
            f"quant ran on {meta['quant_timings']['device']}")
    say(f"quant -l IU on the k = {PREFIX_K} index: {mates[0].shape[0]} "
        f"paired fragments, {meta['num_mapped']} mapped, "
        f"{int(eq[0].split(chr(10))[1])} eq classes identical to the refimpl "
        f"backend's, quant.sf equal at rtol 1e-9; prefix kernel launches "
        f"{dl['mmp_scan_prefix']}; CLI wall {secs['device']:.1f}s (refimpl "
        f"{secs['refimpl']:.1f}s) [{card}]")
    return dl


def phase_sharded_cli(torch, cli, wdir, idx4_dir, batch, card):
    """`quant -l IU --dumpEq` on the sharded index directory through the
    CLI, on the paired 100 bp library of phase 7: eq_classes.txt
    identical to the monolithic run's, quant.sf equal at rtol 1e-9, the
    facts, slot and replay kernels (its shards mode, the k-mer route's)
    launched, and neither the monolithic scan nor the replay's plane mode,
    and no `FactsMerge` built.  Returns the launch counts."""
    from sailfish_tpu_torch.map.facts import FactsMerge

    reads = ["-l", "IU", "-1", os.path.join(wdir, "reads_pe100_1.fq"),
             "-2", os.path.join(wdir, "reads_pe100_2.fq")]
    out = os.path.join(wdir, "quant_sharded")
    shutil.rmtree(out, ignore_errors=True)
    merges = []
    init = FactsMerge.__init__

    def counted_init(self, *a, **kw):
        merges.append(1)
        init(self, *a, **kw)

    _launch_counts(reset=True)
    FactsMerge.__init__ = counted_init
    t0 = time.time()
    try:
        rc = cli.main(["quant", "-i", idx4_dir, "-o", out, *reads,
                       "--hitCapacity", "64", "--hitCapacityMax", "1024",
                       "--dumpEq", "--batchSize", str(batch)])
    finally:
        FactsMerge.__init__ = init
    wall = time.time() - t0
    n = _launch_counts()
    require(rc == 0, f"quant on the sharded index exited {rc}")
    require(n["mmp_facts"] > 0 and n["mmp_replay_shards"] > 0
            and n["mmp_slots"] > 0 and n["mmp_scan"] == 0
            and n["mmp_replay"] == 0 and not merges,
            f"quant on the sharded index launched {n} and built "
            f"{len(merges)} FactsMerge")
    single = os.path.join(wdir, "quant_pe100")
    eq, want_eq = (open(os.path.join(o, "aux", "eq_classes.txt")).read()
                   for o in (out, single))
    require(eq == want_eq, "quant on the sharded index: eq_classes.txt "
            "differs from the monolithic run's")
    require(np.allclose(_quant_sf(out), _quant_sf(single), rtol=1e-9,
                        atol=0), "quant on the sharded index: quant.sf "
            "differs from the monolithic run's beyond rtol 1e-9")
    qt = {}
    for tag, o in (("sharded", out), ("single", single)):
        with open(os.path.join(o, "aux", "meta_info.json")) as fh:
            qt[tag] = json.load(fh)["quant_timings"]
    require(qt["sharded"]["device"].startswith("cuda"),
            f"quant ran on {qt['sharded']['device']}")
    say(f"quant -l IU --dumpEq on the {SHARDS}-shard index: eq_classes.txt "
        f"identical to the monolithic run's ({int(eq.split(chr(10))[1])} "
        f"classes), quant.sf equal at rtol 1e-9; launches facts "
        f"{n['mmp_facts']}, replay {n['mmp_replay_shards']} (shards mode; "
        f"plane mode {n['mmp_replay']}, FactsMerge built {len(merges)}), "
        f"slots "
        f"{n['mmp_slots']}; index load {qt['sharded']['index_load_seconds']}s"
        f", mapping {qt['sharded']['mapping_seconds']}s (batch ms "
        f"{qt['sharded']['batch_ms']}) against "
        f"{qt['single']['mapping_seconds']}s monolithic (batch ms "
        f"{qt['single']['batch_ms']}); CLI wall {wall:.1f}s [{card}]")
    return n


# ---------------------------------------------------------------- dist
DIST_SAMPLE = 2048   # fragments of the prefix-route step, card against CPU
DIST_REPS = 5        # steps a card rank runs; the first loads the kernels


def _dist_inputs(index, n):
    """The step's effective lengths (transcript length less the mean
    fragment length of 250, at least 1) and the uniform alpha of the
    JAX dryrun (n fragments over the transcripts), float32."""
    T = index.num_transcripts
    eff = np.maximum(index.txp_lens.astype(np.float64) - 250.0, 1.0)
    return eff.astype(np.float32), np.full(T, float(n) / T, np.float32)


def _dist_kw(index, use_hash, L):
    """The step's keywords at the main path's options (C = 64, 4 MMPs,
    the step budget of read width L), on the route `use_hash` names."""
    from sailfish_tpu_torch.config import QuantOpts

    ht = index.kmer_ht
    return dict(k=index.k, prefix_bases=index.prefix_bases, cand_cap=64,
                max_mmps=4, max_steps=QuantOpts().effective_scan_steps(L),
                use_hash=use_hash,
                ht_probes=int(ht["max_probes"]) if use_hash else 0,
                ht_bits=int(ht["ht_bits"]) if use_hash else 0)


def _map_prefetched_ms(index, tidx, batch, skip):
    """ms of the device backend's `map_prefetched` on the batch, at the
    main path's options under skip rule `skip` (host clock, the card
    synchronized before and after), DIST_REPS times."""
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.device import synchronize
    from sailfish_tpu_torch.io.fastq import FastqBatch
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend

    be = DeviceMapperBackend(index, QuantOpts(hit_capacity=64,
                                              hit_capacity_max=1024,
                                              mmp_skip=skip),
                             tidx.device, tindex=tidx)
    pf = be.prefetch_pe(FastqBatch(batch[0], batch[1]),
                        FastqBatch(batch[2], batch[3]))
    exp = parse_library_format("IU")
    ms = []
    for _ in range(DIST_REPS):
        synchronize(tidx.device)
        t0 = time.perf_counter()
        be.map_prefetched(pf, exp)
        synchronize(tidx.device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def _profile_step(torch, step, args, dev, top=6):
    """One call of `step` under torch.profiler after a warm call: its
    host-clock ms, the device's busy ms and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sailfish_tpu_torch.bench import device_us
    from sailfish_tpu_torch.device import synchronize

    step(*args)
    synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        synchronize(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    evts = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and device_us(e) > 0), key=device_us, reverse=True)
    return {"wall_ms": wall,
            "busy_ms": sum(device_us(e) for e in evts) / 1e3,
            "top": [(e.key[:70], device_us(e) / 1e3, e.count)
                    for e in evts[:top]]}


def dist_card_rank(mesh, idx_dir, batch, sample):
    """A rank of phase 15 on the card (dist.spawn runs it): loads the
    world's index from .smoke_cache and runs the k-mer route's step on
    the whole batch DIST_REPS times.  At world 1 also: the exact eq
    classes of the same batch from the device backend's
    `finish_batch_fast` (no escalation, the jump rule that the step
    scans under), `map_prefetched`'s ms on the batch, and the prefix
    route's step on the sample."""
    import torch

    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.index.builder import load_index
    from sailfish_tpu_torch.index.device import TorchIndex
    from sailfish_tpu_torch.parallel.dist import host_classes, run_step

    t0 = time.time()
    index = load_index(idx_dir)
    tidx = TorchIndex.from_quasi_index(index, mesh.device)
    L = batch[0].shape[1]
    eff, alpha = _dist_inputs(index, len(batch[0]))
    out = {"ready_s": time.time() - t0,
           "hash": run_step(mesh, tidx, eff, batch, alpha,
                            _dist_kw(index, True, L), DIST_REPS)}
    if mesh.size > 1:
        return out
    from sailfish_tpu_torch.parallel.dist import distributed_quant_step

    step = distributed_quant_step(mesh, tidx, eff,
                                  **_dist_kw(index, True, L))
    dev_batch = tuple(torch.as_tensor(x).to(mesh.device) for x in batch)
    out["profile"] = _profile_step(torch, step, (*dev_batch, alpha),
                                   mesh.device)
    del step, dev_batch
    out["classes"] = host_classes(
        index, QuantOpts(hit_capacity=64, hit_capacity_max=0, max_mmps=4,
                         mmp_skip="jump"), mesh.device, batch, tindex=tidx)
    out["map_prefetched_ms"] = {
        skip: _map_prefetched_ms(index, tidx, batch, skip)
        for skip in ("nip", "jump")}
    del tidx
    torch.cuda.empty_cache()
    eff, alpha = _dist_inputs(index, len(sample[0]))
    out["prefix"] = run_step(mesh, index, eff, sample, alpha,
                             _dist_kw(index, False, L))
    return out


def dist_cpu_rank(mesh, idx_dir, sample):
    """The prefix route's step on the sample on the CPU: the plain
    versions of the kernels, one gloo rank."""
    from sailfish_tpu_torch.index.builder import load_index
    from sailfish_tpu_torch.parallel.dist import run_step

    index = load_index(idx_dir)
    eff, alpha = _dist_inputs(index, len(sample[0]))
    return run_step(mesh, index, eff, sample, alpha,
                    _dist_kw(index, False, sample[0].shape[1]))


def phase_em_update(torch, dev, card):
    """The step's EM update (dist.py `_fragment_em_update`) on a label
    matrix of the paired batch's shape (65,536 fragments x 4 C = 256
    slots, 1-7 members each, seed 19), timed with CUDA events; beside it
    its closing `index_add_` alone, with the PAD slots' zeros spread over
    the bins as the update adds them, and sent to bin 0 as a literal
    port of the JAX `segment_sum` over `where(valid, label, 0)` would."""
    from sailfish_tpu_torch.parallel.dist import _fragment_em_update

    rng = np.random.default_rng(19)
    B, W, T = 65536, 256, 186173
    n = rng.integers(1, 8, B)
    label = np.full((B, W), -1, np.int32)
    for i in range(B):
        label[i, :n[i]] = np.sort(rng.choice(T, n[i], replace=False))
    label = torch.from_numpy(label).to(dev)
    label_len = torch.from_numpy(n.astype(np.int32)).to(dev)
    alpha = torch.from_numpy(rng.random(T).astype(np.float32)).to(dev)
    eff = torch.from_numpy(rng.uniform(0, 3000, T).astype(np.float32)
                           ).to(dev)
    got = _fragment_em_update(label, label_len, alpha, eff, T)
    require(bool(torch.isfinite(got).all())
            and abs(float(got.sum()) - B) < 1e-3 * B,
            "EM update: alpha does not sum to the fragments")
    valid = label >= 0
    index = {"spread": torch.where(
                 valid, label.long(),
                 torch.arange(B * W, device=dev).view(B, W) % T).reshape(-1),
             "bin0": torch.where(valid, label, 0).long().reshape(-1)}
    zeros = torch.zeros(B * W, device=dev)
    ms = {"update": _time_ms(torch, lambda: _fragment_em_update(
        label, label_len, alpha, eff, T), 10)}
    for key, idx in index.items():
        ms[key] = _time_ms(torch, lambda idx=idx: torch.zeros(
            T, device=dev).index_add_(0, idx, zeros), 10)
    say(f"dist EM update on {B} x {W} label slots ({int(n.sum())} members): "
        f"{ms['update']:.3f} ms; its index_add_ alone {ms['spread']:.3f} ms "
        f"with the PAD slots' zeros spread over the bins, "
        f"{ms['bin0']:.3f} ms with them all on bin 0 [{card}]")
    return ms


def _dist_same(got, want, what):
    """Alpha at rtol 1e-5, everything else exactly; returns alpha's
    largest relative difference."""
    require(got["alpha"].dtype == np.float32, f"{what}: alpha not float32")
    for key in ("fld", "eq_counts", "eq_checksum"):
        require(np.array_equal(got[key], want[key]),
                f"{what}: {key} differs")
    require(got["num_mapped"] == want["num_mapped"],
            f"{what}: {got['num_mapped']} mapped against "
            f"{want['num_mapped']}")
    require(np.allclose(got["alpha"], want["alpha"], rtol=1e-5, atol=0),
            f"{what}: alpha differs beyond rtol 1e-5")
    a, b = got["alpha"].astype(np.float64), want["alpha"].astype(np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _steady(ms):
    return float(np.median(ms[1:]))


def phase_dist(torch, idx_dir, mates, card):
    """The data-parallel step (parallel/dist.py) on the world's k = 31
    index and the paired batch `mates`, its ranks spawned as the entry
    point spawns them: world 1 on NCCL against the exact eq classes of
    the device backend; world 2 on gloo, both ranks on the one card,
    against world 1; the prefix route on the card against the plain
    versions on the CPU.  The CPU rank starts after the card's ranks have
    ended, so that no step is timed while it takes the host's cores.
    Returns the scan kernels' launches by run."""
    from sailfish_tpu_torch.bench import padded
    from sailfish_tpu_torch.parallel.dist import (
        check_step, same_on_every_rank, spawn)

    t_start = time.time()
    lens = np.full(len(mates[0]), mates[0].shape[1], np.int32)
    batch = (padded(mates[0]), lens, padded(mates[1]), lens)
    sample = tuple(x[:DIST_SAMPLE] for x in batch)
    try:
        w1 = spawn(dist_card_rank, 1, idx_dir, batch, sample,
                   device="cuda", timeout=600)[0]
        w2 = spawn(dist_card_rank, 2, idx_dir, batch, sample,
                   device="cuda", backend="gloo", timeout=600)
        one = w1["hash"]
        slots = check_step(one, *w1["classes"])
        two = same_on_every_rank([r["hash"] for r in w2])
        t_cpu = time.time()
        plain = spawn(dist_cpu_rank, 1, idx_dir, sample, device="cpu",
                      threads=4, timeout=600)[0]
        t_cpu = time.time() - t_cpu
    except (RuntimeError, ValueError) as e:
        raise SmokeFailure(f"dist: {e}") from None
    B = len(batch[0])
    require(one["launches"] == {"mmp_scan": DIST_REPS, "mmp_scan_prefix": 0},
            f"dist world 1: scan launches {one['launches']}")
    say(f"dist world 1 (NCCL): {B} fragments, {one['num_mapped']} mapped, "
        f"{len(w1['classes'][2])} classes in {slots} slots: the merged eq "
        f"table equals expected_eq_table of finish_batch_fast's classes "
        f"slot for slot (counts and checksums), alpha sums to "
        f"{one['alpha'].sum(dtype=np.float64):.3f}; collision detector "
        f"silent on single-label slots, firing on a corrupted one; "
        f"sf_mmp_scan launches {one['launches']['mmp_scan']} in "
        f"{DIST_REPS} steps; step ms {[round(x, 3) for x in one['ms']]}, "
        f"steady {_steady(one['ms']):.3f} (index load + upload "
        f"{w1['ready_s']:.1f}s) [{card}]")
    mp = w1["map_prefetched_ms"]
    say(f"dist: map_prefetched on the same batch (one process, C = 64): "
        f"nip rule (the main path) {[round(x, 3) for x in mp['nip']]} ms, "
        f"steady {_steady(mp['nip']):.3f}; jump rule (the step's) "
        f"{[round(x, 3) for x in mp['jump']]} ms, steady "
        f"{_steady(mp['jump']):.3f} [{card}]")
    err2 = _dist_same(two, one, "dist world 2 (gloo) against world 1")
    for r, res in enumerate(w2):
        require(res["hash"]["launches"]["mmp_scan"] == DIST_REPS,
                f"dist world 2 rank {r}: launches {res['hash']['launches']}")
    say(f"dist world 2 (gloo, both ranks on the one card, {B // 2} "
        f"fragments each): outputs equal world 1's (alpha largest relative "
        f"difference {err2:.3e}, the rest exact); step ms rank 0 "
        f"{[round(x, 3) for x in w2[0]['hash']['ms']]}, rank 1 "
        f"{[round(x, 3) for x in w2[1]['hash']['ms']]}, steady "
        f"{max(_steady(r['hash']['ms']) for r in w2):.3f} [{card}]")
    pre = w1["prefix"]
    require(pre["launches"] == {"mmp_scan": 0, "mmp_scan_prefix": 1},
            f"dist prefix route: scan launches {pre['launches']}")
    require(pre["num_mapped"] > 0 and abs(
        pre["alpha"].sum(dtype=np.float64) - pre["num_mapped"])
        < 1e-2 * pre["num_mapped"], "dist prefix route: alpha sum")
    err3 = _dist_same(pre, plain, "dist prefix route, card against CPU")
    say(f"dist prefix route (use_hash=False on the k = 31 arrays), world 1, "
        f"{DIST_SAMPLE} fragments: the card's outputs equal the CPU's plain "
        f"versions (alpha largest relative difference {err3:.3e}, the rest "
        f"exact; {pre['num_mapped']} mapped); sf_mmp_scan_prefix launches "
        f"{pre['launches']['mmp_scan_prefix']}; step ms card "
        f"{pre['ms'][0]:.3f} (first call), CPU {plain['ms'][0]:.3f} (the "
        f"CPU rank's process {t_cpu:.1f}s, after the card's) [{card}]")
    prof = w1["profile"]
    say(f"dist world 1 step under torch.profiler (after a warm step): wall "
        f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); top kernels: "
        + "; ".join(f"{name} {ms:.3f} ms x{cnt}"
                    for name, ms, cnt in prof["top"]) + f" [{card}]")
    phase_em_update(torch, torch.device("cuda"), card)
    say(f"dist: phase took {time.time() - t_start:.1f}s")
    return ({"dist_world1": one["launches"]["mmp_scan"],
             "dist_world2": sum(r["hash"]["launches"]["mmp_scan"]
                                for r in w2)},
            {"dist_prefix_world1": pre["launches"]["mmp_scan_prefix"]})


def phase_end_to_end(torch, cli, wdir, idx_dir, tag, lib, mates, batch,
                     card):
    """One `quant` run through the CLI entry point on the reads of
    `mates` ((m1, m2) paired, (m,) single-end), with the launch counts of
    the scan kernel and of the EM kernel (csrc/em.cu) read before and
    after; outputs checked, and the run's one EM solve must have launched
    the EM kernel once.  Returns (scan launches, EM launches)."""
    from sailfish_tpu_torch.eqclass.io import read_eq_classes
    from sailfish_tpu_torch import trace

    paths = []
    for i, m in enumerate(mates, 1):
        paths.append(os.path.join(wdir, f"reads_{tag}_{i}.fq"))
        write_fastq(paths[-1], m)
    n, rl = mates[0].shape
    reads = ["-1", paths[0], "-2", paths[1]] if len(mates) == 2 \
        else ["-r", paths[0]]
    out = os.path.join(wdir, f"quant_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    launches0 = trace.counter("launch.mmp_scan")
    em0 = trace.counter("launch.em_solve")
    t0 = time.time()
    rc = cli.main(["quant", "-i", idx_dir, "-l", lib, *reads,
                   "-o", out, "--hitCapacity", "64", "--hitCapacityMax",
                   "1024", "--dumpEq", "--batchSize", str(batch)])
    wall = time.time() - t0
    launches = trace.counter("launch.mmp_scan") - launches0
    em_launches = trace.counter("launch.em_solve") - em0
    require(rc == 0, f"quant -l {lib} exited {rc}")
    require(launches > 0, f"quant -l {lib} ({tag}) launched the scan "
            "kernel 0 times")
    require(em_launches == 1, f"quant -l {lib} ({tag}) launched the EM "
            f"kernel {em_launches} times for its one solve")

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
        f"EM kernel launches {em_launches}, "
        f"TPM sum {tpm:.3f}, on {qt['device']}, CLI wall {wall:.1f}s "
        f"[{card}]")
    say(f"quant -l {lib} ({tag}) batches: ms {bms} | "
        f"{n / qt['mapping_seconds']:.0f} reads/s over the mapping loop, "
        f"{steady} [{card}]")
    say(f"quant -l {lib} ({tag}) EM: {qt['em_iterations']} iterations in "
        f"{qt['inference_seconds']:.3f}s "
        f"({qt['em_iterations'] / max(qt['inference_seconds'], 1e-9):.1f} "
        f"iterations/s, float64) [{card}]")
    return launches, em_launches


def phase_em(torch, out, card):
    """The EM on the classes and effective lengths of the run in `out`
    (phase 7's paired run): `run_em` on the card, through csrc/em.cu,
    against the plain torch loop on the CPU (the same iterations and
    convergence, alphas at rtol 1e-6, one kernel launch).  Then, gating
    nothing: the kernel's ms a solve (CUDA events, three solves) beside
    its bound and the plain loop's ms on the card.  Returns the kernel
    table's row."""
    from sailfish_tpu_torch.eqclass.io import read_eq_classes
    from sailfish_tpu_torch.infer import em
    from sailfish_tpu_torch import trace

    _, eq = read_eq_classes(os.path.join(out, "aux", "eq_classes.txt"))
    with open(os.path.join(out, "aux", "meta_info.json")) as fh:
        total = float(json.load(fh)["num_mapped"])
    eff = _quant_sf(out)[:, 1]
    T = len(eff)
    launches0 = trace.counter("launch.em_solve")
    t0 = time.time()
    g = em.run_em(eq, eff, total, T, device="cuda")
    t_g = time.time() - t0
    launches = trace.counter("launch.em_solve") - launches0
    t0 = time.time()
    c = em.run_em(eq, eff, total, T, device="cpu")
    t_c = time.time() - t0
    require(launches == 1, f"the EM on the card launched csrc/em.cu "
            f"{launches} times, not once")
    require(g.num_iterations == c.num_iterations
            and g.converged == c.converged,
            f"EM iterations differ: cuda {g.num_iterations} "
            f"({g.converged}), cpu {c.num_iterations} ({c.converged})")
    require(np.allclose(g.alphas, c.alphas, rtol=1e-6, atol=1e-8),
            "EM alphas differ between cuda and cpu beyond rtol 1e-6")
    rel = np.abs(g.alphas - c.alphas) / np.maximum(np.abs(c.alphas), 1e-300)
    err = float(rel[c.alphas > 0].max(initial=0.0))
    say(f"EM cuda vs cpu: {g.num_iterations} iterations both, max rel "
        f"diff {err:.3g}, csrc/em.cu launches {launches} (cuda "
        f"{t_g:.2f}s with the upload, cpu {t_c:.2f}s) [{card}]")

    # timing only: the kernel and the plain loop from one uploaded problem
    dev = torch.device("cuda")
    p = em._Problem(eq, eff, T, dev, torch.float64)
    active = np.zeros(T, dtype=bool)
    active[np.unique(eq.members)] = True
    a0 = torch.as_tensor(np.where(active, total / active.sum(), 0.0),
                         dtype=torch.float64, device=dev)
    lim = dict(min_iter=50, max_iter=10000, rel_diff_tol=0.01)
    its = []

    def kernel():
        its.append(em._iterate_cuda(p, a0.clone(), **lim)[2])

    ms = _time_ms(torch, kernel, 3)
    plain_ms = _time_ms(torch, lambda: em._iterate(
        p, a0.clone(), em._em_step, **lim), 1)
    M, C = len(eq.members), eq.num_classes
    # each iteration: a transcript, a class and a weight a member (int32,
    # int32, float64), an offset and a count a class, and a transcript's
    # alpha read, singleton count read and new alpha written
    step_bytes = 16 * M + 12 * C + 24 * T
    bound = bound_ms(its[-1] * step_bytes, 0)
    floor = {n: _em_floor_us(torch, em, n) for n in (1000, T)}
    say(f"EM kernel: {its[-1]} iterations over {M} members, {C} classes "
        f"(the largest {int(np.diff(eq.offsets).max())} members), {T} "
        f"transcripts (the most classes a transcript "
        f"{int(np.bincount(eq.members).max())}): {ms:.3f} ms a solve "
        f"({1e3 * ms / its[-1]:.2f} us an iteration), bound "
        f"{bound['bound_ms']:.3f} ms by {bound['bound_by']} at the HBM "
        f"rate ({ms / bound['bound_ms']:.1f} times; an iteration's "
        f"{step_bytes} bytes stay in L2, so their floor is lower still); "
        f"the floor of the barriers and load chains (pairs of transcripts "
        f"as classes) "
        + ", ".join(f"{us:.2f} us an iteration at {n} transcripts"
                    for n, us in floor.items())
        + f" ({ms / its[-1] * 1e3 / floor[T]:.1f} times the floor at {T})"
        f"; the plain loop on the card {plain_ms:.3f} ms [{card}]")
    return {"name": "em_solve", "route": "cuda", "source": EM_SRC,
            "replaces": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None,
            "floor_us_by_transcripts": floor,
            "iterations": its[-1], "members": M, "classes": C,
            "transcripts": T}


def _em_floor_us(torch, em, num_txps):
    """us an iteration of csrc/em.cu where the work is least: classes of
    two neighbouring transcripts, each transcript in one class, 1,000
    iterations run to the cap.  What is left is the two grid barriers a
    step and the chains of dependent loads of a row."""
    from sailfish_tpu_torch.eqclass.classes import EqClasses

    n = max(num_txps // 2 * 2, 2)
    eq = EqClasses.from_items([((t, t + 1), 10) for t in range(0, n, 2)])
    p = em._Problem(eq, np.full(n, 1000.0), n, torch.device("cuda"),
                    torch.float64)
    a0 = torch.full((n,), 10.0, dtype=torch.float64, device="cuda")
    lim = dict(min_iter=1000, max_iter=1000, rel_diff_tol=0.0)
    ms = _time_ms(torch, lambda: em._iterate_cuda(p, a0.clone(), **lim), 3)
    return 1e3 * ms / 1000


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
    from sailfish_tpu_torch.bench import fastq_batch
    from sailfish_tpu_torch.stats.bias import BiasState

    exp = parse_library_format("IU")
    b1, b2 = (fastq_batch(m) for m in mates)
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
    from sailfish_tpu_torch.bench import fastq_batch
    from sailfish_tpu_torch.config import QuantOpts
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend

    exp = parse_library_format("IU")
    b1, b2 = (fastq_batch(m) for m in batch)
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
    from sailfish_tpu_torch import trace

    out = os.path.join(wdir, f"quant_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    launches0 = trace.counter("launch.mmp_scan")
    rc = cli.main(["quant", "-i", idx_dir, "-o", out, "--hitCapacity", "64",
                   "--hitCapacityMax", "1024", *argv])
    launches = trace.counter("launch.mmp_scan") - launches0
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
    100 bp library of phase 7, through the CLI; each EM segment must
    have launched the EM kernel once.  Returns (outputs, the scan
    kernel's launches, the EM kernel's launches) by run."""
    from sailfish_tpu_torch import trace

    reads = ["-l", "IU", "-1", os.path.join(wdir, "reads_pe100_1.fq"),
             "-2", os.path.join(wdir, "reads_pe100_2.fq")]
    outs, launches, em_launches = {}, {}, {}
    for tag, flag in (("bias_seq", "--biasCorrect"),
                      ("bias_gc", "--gcBiasCorrect")):
        em0 = trace.counter("launch.em_solve")
        t0 = time.time()
        out, meta, launches[tag], st = run_quant_cli(
            cli, wdir, idx_dir, tag,
            [*reads, flag, "--dumpEq", "--batchSize", str(batch)], maps=True)
        wall = time.time() - t0
        em_launches[tag] = trace.counter("launch.em_solve") - em0
        qt = meta["quant_timings"]
        # a segment a solve: one more than the effective-length updates
        segments = len(qt["bias_update_seconds"]) + 1
        require(em_launches[tag] == segments, f"{flag}: the EM kernel "
                f"launched {em_launches[tag]} times for {segments} segments")
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
            f"changed, kernel launches {launches[tag]}, EM kernel launches "
            f"{em_launches[tag]}, batch ms "
            f"{qt['batch_ms']}, CLI wall {wall:.1f}s [{card}]")
        outs[tag] = (out, meta, len(upd))
    return outs, launches, em_launches


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


def phase_big_cli(torch, cli, wdir, idx_dir, batch, card):
    """The CLI on a 64-bit index directory (the world's index in the
    big_sa layout, saved with the port's builder): `quant -l IU` gives
    the 32-bit run's eq_classes.txt and its quant.sf at rtol 1e-9, and
    `--gcBiasCorrect` (the int64 GC prefix) the 32-bit bias run's."""
    from sailfish_tpu_torch.index.builder import load_index, save_index

    big_dir = os.path.join(wdir, "index64")
    t0 = time.time()
    save_index(big_index(load_index(idx_dir)), big_dir)
    say(f"64-bit index directory: the world's index with int64 suffix "
        f"array, table lo and prefix table, saved in {time.time() - t0:.1f}s")
    reads = ["-l", "IU", "-1", os.path.join(wdir, "reads_pe100_1.fq"),
             "-2", os.path.join(wdir, "reads_pe100_2.fq")]
    launches = {}
    for tag, ref, flags in (("pe100_64", "pe100", []),
                            ("bias_gc_64", "bias_gc", ["--gcBiasCorrect"])):
        t0 = time.time()
        out, meta, launches[tag], st = run_quant_cli(
            cli, wdir, big_dir, tag,
            [*reads, *flags, "--dumpEq", "--batchSize", str(batch)],
            maps=True)
        wall = time.time() - t0
        ref_out = os.path.join(wdir, f"quant_{ref}")
        eq, want_eq = (open(os.path.join(o, "aux", "eq_classes.txt")).read()
                       for o in (out, ref_out))
        require(eq == want_eq, f"quant on the 64-bit index ({tag}): "
                f"eq_classes.txt differs from the 32-bit run's")
        got, want = _quant_sf(out), _quant_sf(ref_out)
        require(np.allclose(got, want, rtol=1e-9, atol=0),
                f"quant on the 64-bit index ({tag}): quant.sf differs from "
                "the 32-bit run's beyond rtol 1e-9")
        qt = meta["quant_timings"]
        say(f"quant {' '.join(['-l', 'IU', *flags])} on the 64-bit index: "
            f"eq_classes.txt identical to the 32-bit run's "
            f"({int(eq.split(chr(10))[1])} classes), quant.sf "
            f"equal at rtol 1e-9 (effective lengths included), kernel "
            f"launches {launches[tag]}, mapping {qt['mapping_seconds']}s, "
            f"batch ms {qt['batch_ms']}, EM {qt['em_iterations']} "
            f"iterations, CLI wall {wall:.1f}s [{card}]")
    return launches


def phase_launcher(torch, cli, wdir, idx_dir, batch, card):
    """`quant --numShards 2` without --shardId on the paired 100 bp
    library: two shard processes on the one card; merged eq classes as a
    set of lines equal to the single run's; quant.sf equal (rtol 1e-9) to
    the hand-run route from the same shard runs (`--shardId 0/1
    --mapOnly`: `mergeeq`, the shards' states added up here, not by the
    launcher, `--resumeFromEq`); `--biasCorrect` refused."""
    reads = ["-l", "IU", "-1", os.path.join(wdir, "reads_pe100_1.fq"),
             "-2", os.path.join(wdir, "reads_pe100_2.fq")]
    t0 = time.time()
    # the shard processes launch the kernel; the parent maps nothing
    out, meta, _, st = run_quant_cli(
        cli, wdir, idx_dir, "launcher",
        [*reads, "--numShards", "2", "--dumpEq", "--batchSize", str(batch)],
        maps=False)
    wall = time.time() - t0
    single = os.path.join(wdir, "quant_pe100")

    def lines(o):
        with open(os.path.join(o, "aux", "eq_classes.txt")) as fh:
            return sorted(fh.read().splitlines())

    require(lines(out) == lines(single), "quant --numShards 2: merged "
            "eq_classes.txt differs from the single run's")
    shards = [os.path.join(out, "_shards", f"shard{sid}") for sid in (0, 1)]
    shard_s, states = [], []
    for sid, sdir in enumerate(shards):
        with open(os.path.join(sdir, "aux", "meta_info.json")) as fh:
            sm = json.load(fh)
        require(sm["quant_timings"]["device"].startswith("cuda"),
                f"shard {sid} ran on {sm['quant_timings']['device']}")
        shard_s.append(sm["quant_timings"]["mapping_seconds"])
        with open(os.path.join(sdir, "aux", "quant_state.json")) as fh:
            states.append(json.load(fh))
    require(meta["num_processed"] == 2 * batch, "quant --numShards 2: "
            f"{meta['num_processed']} fragments, not {2 * batch}")

    # the route: the shards' dumps merged by `mergeeq`, their counters and
    # FLD histograms added up here, and one resumed run
    merged = os.path.join(wdir, "route_merged")
    shutil.rmtree(merged, ignore_errors=True)
    os.makedirs(os.path.join(merged, "aux"))
    require(cli.main(["mergeeq", *shards, "-o", os.path.join(
        merged, "aux", "eq_classes.txt")]) == 0, "mergeeq failed")
    state = {k: sum(int(d[k]) for d in states) for k in (
        "num_observed", "num_mapped", "num_frag_hits", "upper_bound_hits",
        "num_fwd", "num_rc")}
    hist = np.sum([np.asarray(d["fl_hist"], np.int64) for d in states],
                  axis=0)
    state["fl_hist"] = hist.tolist()
    state["remaining_fl_ops"] = max(0, 10000 - int(hist.sum()))
    with open(os.path.join(merged, "aux", "quant_state.json"), "w") as fh:
        json.dump(state, fh)
    route, _, _, _ = run_quant_cli(cli, wdir, idx_dir, "route",
                                   ["-l", "IU", "--resumeFromEq", merged],
                                   maps=False)
    require(np.allclose(_quant_sf(out), _quant_sf(route), rtol=1e-9, atol=0),
            "quant --numShards 2: quant.sf differs from the --shardId + "
            "mergeeq + --resumeFromEq route's beyond rtol 1e-9")
    try:
        rc = cli.main(["quant", "-i", idx_dir, "-o",
                       os.path.join(wdir, "quant_refused"), *reads,
                       "--numShards", "2", "--biasCorrect"])
    except SystemExit as e:
        rc = e.code
    require(rc == 2, f"quant --numShards 2 --biasCorrect exited {rc}, not 2")
    with open(os.path.join(single, "aux", "meta_info.json")) as fh:
        single_s = json.load(fh)["quant_timings"]["mapping_seconds"]
    say(f"quant --numShards 2: two shard processes on the card, "
        f"{meta['num_processed']} fragments, merged eq classes equal to the "
        f"single run's as a set of lines, quant.sf equal (rtol 1e-9) to the "
        f"route from its shards' dumps (mergeeq, states added up here, "
        f"--resumeFromEq); mapping {st['map_seconds']:.3f}s (shard "
        f"processes started to ended; each shard's own mapping loop "
        f"{shard_s[0]}s and {shard_s[1]}s) against {single_s}s in one "
        f"process; CLI wall {wall:.1f}s; --biasCorrect refused (exit 2) "
        f"[{card}]")


# the bench's metrics and the units it gives them, by world
BENCH_METRICS = {
    "uniform": {"reads_per_sec_per_chip": "reads/s"},
    "gencode": {"gencode_index_load_s": "s",
                "gencode_reads_per_sec": "frags/s",
                "gencode_em_iters_per_sec": "iters/s",
                "gencode_bootstraps_per_sec": "replicates/s",
                "gencode_gibbs_samples_per_sec": "samples/s"},
}


def phase_bench(args, idx_dir, card):
    """`python -m sailfish_tpu_torch.bench` as a user runs it, a process
    for each world (its narrative streams to this script's stderr): the
    uniform world of bench.py with its index cached in .smoke_cache/, and
    the gene-family world on phase 3's k = 31 index at --bench-reads
    fragments with 16 bootstraps, 16 Gibbs samples and the breakdown.
    Every metric line must be there, finite, positive and from cuda, the
    run's --check must have passed and the scan kernel must have been
    launched in its timed loop.  Returns the launches by run."""
    # --check at 512 fragments (the bench's default is 2,048): phase 5
    # holds the gencode world's first 2,048 fragments, the same ones,
    # against the same oracle, and the oracle takes about 30 ms a fragment
    runs = {
        "uniform": ["--cache", os.path.join(CACHE, "bench"), "--check",
                    "512"],
        "gencode": ["--index-dir", idx_dir, "--check", "512",
                    "--txps", str(args.txps),
                    "--bases", str(args.bases), "--batch", str(args.batch),
                    "--reads", str(args.bench_reads), "--bootstraps", "16",
                    "--gibbs", "16", "--breakdown"],
    }
    launches = {}
    for world, argv in runs.items():
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "sailfish_tpu_torch.bench", "--world",
             world, *argv], cwd=ROOT, stdout=subprocess.PIPE, text=True,
            timeout=900)
        wall = time.time() - t0
        require(proc.returncode == 0,
                f"bench --world {world} exited {proc.returncode}")
        docs = [json.loads(ln) for ln in proc.stdout.splitlines()]
        got = {d["metric"]: d["unit"] for d in docs}
        require(got == BENCH_METRICS[world],
                f"bench --world {world}: metric lines {got}")
        for d in docs:
            require(d["device"] == "cuda" and np.isfinite(d["value"])
                    and d["value"] > 0, f"bench --world {world}: {d}")
            say(f"bench --world {world}: {json.dumps(d)}")
        rate, = (d for d in docs if "scan_launches" in d)
        require(rate["checked"] > 0,
                f"bench --world {world}: the check did not run")
        require(rate["scan_launches"] > 0,
                f"bench --world {world}: no scan kernel launch")
        launches[f"bench_{world}"] = rate["scan_launches"]
        ms = np.array(rate["batch_ms"])
        say(f"bench --world {world}: {rate['metric']} {rate['value']:.1f} "
            f"{rate['unit']}, {rate['reads']} fragments in "
            f"{rate['seconds']:.3f}s, batch ms median {np.median(ms):.3f} "
            f"(quartiles {np.percentile(ms, 25):.3f}-"
            f"{np.percentile(ms, 75):.3f}, {len(ms)} batches), scan "
            f"launches {rate['scan_launches']}, --check {rate['checked']} "
            f"fragments passed; process wall {wall:.1f}s [{card}]")
    return launches


# ---------------------------------------------------------------- capacity
def wide_pass(torch, world, run):
    """One cap's escalation pass again, through its backend's own chunks
    (`_esc_chunks` on the fragments that overflowed its main pass), each
    chunk synchronized and its device memory read: per fragment the
    mapped flag, the overflow flag and the label (a tuple, () when
    unmapped), and per chunk (ms, peak MiB above the memory held before
    it)."""
    from sailfish_tpu_torch.libformat import parse_library_format

    steps = run.backend._esc_chunks(
        (world.b1, world.b2, parse_library_format("IU")), run.overflow)
    mapped, over, labels, chunks = [], [], [], []
    while True:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step = next(steps, None)
        if step is None:
            return np.concatenate(mapped), np.concatenate(over), labels, chunks
        ci, _, (res, *_) = step
        m = res["mapped"][:len(ci)].cpu().numpy()
        o = res["overflow"][:len(ci)].cpu().numpy()
        lab = res["label"][:len(ci)].cpu().numpy()
        chunks.append((1e3 * (time.perf_counter() - t0),
                       (torch.cuda.max_memory_allocated() - held) / 2**20))
        mapped.append(m)
        over.append(o)
        labels += [tuple(r[r >= 0]) if f else () for r, f in zip(lab, m)]
        del res, step


def phase_capacity(card, copy_rate):
    """The capacity-envelope tool's repeat mode on the card and its
    gates (phase 17 of the docstring).  Returns (the scan kernel's
    launches by run, the kernel-vs-plain readings of the escalation
    chunk)."""
    import torch

    from sailfish_tpu_torch import capacity_envelope as ce
    from sailfish_tpu_torch.bench import oracle_check
    from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend
    from sailfish_tpu_torch import trace

    frags = 65536        # one production batch
    oracle_frags = 512   # its sample held against the reference mapper
    t_start = time.time()
    rows = DeviceMapperBackend._ESC_ROWS
    launches, kv = {}, {}
    for argv in ([], ["--frags", str(frags), "--caps", "256,1024,2048"]):
        what = f"capacity_envelope --mode repeat {' '.join(argv)}".strip()
        t0 = time.time()
        launches0 = trace.counter("launch.mmp_scan")
        doc, world, runs = ce.run(ce.parse_args(["--mode", "repeat",
                                                 *argv]))
        n_launch = trace.counter("launch.mmp_scan") - launches0
        wall = time.time() - t0
        caps = sorted(runs)
        top, B = caps[-1], doc["frags"]
        launches[f"capacity_repeat_{B}"] = n_launch
        require(doc["device"] == "cuda", f"{what}: ran on {doc['device']}")
        require(all(f"mapped_cap{c}" in doc for c in caps)
                and all(f"dropped_at_{c}_kept_at_{top}" in doc
                        for c in caps[:-1]), f"{what}: keys missing")
        esc = runs[caps[0]].escalated
        require(esc > 0 and all(r.escalated == esc for r in runs.values()),
                f"{what}: escalated {[r.escalated for r in runs.values()]}"
                " (the main pass is the same at every cap, and must "
                "escalate)")
        require(doc["element_interval"] > 256, f"{what}: the element's "
                f"interval is {doc['element_interval']}, not above 256")
        want = len(caps) * (1 + -(-esc // rows))
        require(n_launch == want, f"{what}: {n_launch} scan launches, not "
                f"the {want} of a main pass and {-(-esc // rows)} "
                "escalation chunks a cap")
        # the fragments the main pass overflowed, and the wide pass on
        # them at each cap, fragment by fragment
        idx = runs[caps[0]].overflow
        require(len(idx) == esc and all(np.array_equal(r.overflow, idx)
                                        for r in runs.values()),
                f"{what}: the overflowed fragments differ from cap to cap "
                f"or from the {esc} escalated")
        wide = {c: wide_pass(torch, world, runs[c]) for c in caps}
        tidx = runs[caps[0]].backend.tindex
        rest = np.ones(B, bool)
        rest[idx] = False
        for a, b in zip(caps, caps[1:]):
            ma, mb = runs[a].result.mapped, runs[b].result.mapped
            require(not (ma & ~mb).any(), f"{what}: "
                    f"{int((ma & ~mb).sum())} fragments mapped at cap {a} "
                    f"and dropped at {b}")
            require(np.array_equal(ma[rest], mb[rest]),
                    f"{what}: caps {a} and {b} differ on fragments that "
                    "did not escalate")
            (wma, woa, wla, _), (wmb, wob, wlb, _) = wide[a], wide[b]
            keep = np.nonzero(~woa)[0]
            require(not (wob & ~woa).any(), f"{what}: a wide pass that "
                    f"overflows at {b} and not at {a}")
            require(np.array_equal(wma[keep], wmb[keep])
                    and all(wla[i] == wlb[i] for i in keep),
                    f"{what}: labels at caps {a} and {b} differ where the "
                    f"cap-{a} wide pass did not overflow")
        for c in caps:
            wm, wo, _, chunks = wide[c]
            require(np.array_equal(wm, runs[c].result.mapped[idx]),
                    f"{what}: cap {c}: the tool's mapped flags differ from "
                    "the wide pass run again")
            require(not (wm & wo).any(), f"{what}: cap {c}: a fragment "
                    "overflowed and mapped")
            say(f"{what}: cap {c}: {len(idx)} escalated, wide pass "
                f"overflowed {int(wo.sum())}, mapped {int(wm.sum())}; "
                f"{len(chunks)} chunks of <= {rows} fragments, ms "
                f"{', '.join(f'{x[0]:.3f}' for x in chunks)}, device memory "
                f"above the held {', '.join(f'{x[1]:.1f}' for x in chunks)}"
                f" MiB (synchronized, submit + pull of mapped, overflow, "
                f"label) [{card}]")
        for c in caps[:-1]:
            say(f"{what}: dropped at --hitCapacityMax {c}, kept at {top}: "
                f"{doc[f'dropped_at_{c}_kept_at_{top}']} of {B} "
                f"({100 * doc[f'dropped_at_{c}_kept_at_{top}_frac']:.4f}%)"
                + (" (the JAX package's round-3 TPU run: 0 at 1024)"
                   if c == 1024 else ""))
        say(f"{what}: gates passed; {n_launch} scan launches, wall "
            f"{wall:.1f}s [{card}]")
        if argv:
            # the eq classes of a sample against the oracle at each cap,
            # and the tool's mapped flags against the oracle's
            n = min(oracle_frags, B)
            require((idx < n).any(), f"{what}: no fragment of the first {n}"
                    " escalated")
            sample = (world.b1.codes[:n, :100], world.b2.codes[:n, :100])
            for c in caps:
                ref = oracle_check(world.index, tidx, sample, "IU", (64,),
                                   cap_max=c, out=say, workers=ORACLE_WORKERS)
                require(np.array_equal(ref.mapped,
                                       runs[c].result.mapped[:n]),
                        f"{what}: cap {c}: the tool's mapped flags differ "
                        "from the oracle's on the sample")
            # the scan kernel on the first escalation chunk, at the wide
            # pass's capacities
            ci = idx[:rows]
            kv = phase_kernel_vs_plain(
                torch, tidx, "repeat_escalation",
                _mate_reads((world.b1.codes[ci, :100],
                             world.b2.codes[ci, :100]), False),
                [{"cand_cap": 256}, {"cand_cap": 2048}], card, copy_rate)
        del tidx, world, runs, wide
        torch.cuda.empty_cache()
    say(f"capacity: phase took {time.time() - t_start:.1f}s")
    return launches, kv

STAMP_FILL = 0x5A5A5A5A    # a step that no read of these reaches


def stamped_vs_plain(torch, tidx, tag, reads, cases, card, copy_rate,
                     time_plain=False):
    """The scan's stamped launch (`stamps=True`) against its plain
    version on the oriented lanes of `reads`, as phase 4 takes them: all
    five raw outputs bit for bit, written over 0xFF buffers and stamps
    filled with STAMP_FILL; its first four outputs equal to the stampless
    launch's; timed in turns with it (stampless, stamped, stamped,
    stampless), and the plain version timed with `time_plain` (the row of
    the kernel table).  Returns ({name: readings}, the last case's lanes
    and stamped outputs)."""
    from sailfish_tpu_torch.map.encode import make_oriented_lanes
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda as scan
    from sailfish_tpu_torch.map.scan import mmp_scan_reference

    dev = tidx.device
    codes, lens, what = reads
    L = codes.shape[1]
    lanes = make_oriented_lanes(torch.from_numpy(codes).to(dev),
                                torch.from_numpy(lens).to(dev))
    n_lanes = lanes["codes"].shape[0]
    out, k = {}, None
    for case in cases:
        C = case["cand_cap"]
        kw = {"max_mmps": 4, "max_steps": L, "skip_jump": False, **case}
        name = f"{tag}_L{L}_C{C}" + ("_jump" if kw["skip_jump"] else "")
        del k
        bufs = _ff_outputs(torch, n_lanes, C, dev) + (
            torch.full((n_lanes, 5), STAMP_FILL, dtype=torch.int32,
                       device=dev),)
        k = scan(lanes, tidx, stamps=True, out=bufs, **kw)
        work = {}
        p = mmp_scan_reference(lanes, tidx, stamps=True, work=work, **kw)
        bare = scan(lanes, tidx, **kw)
        torch.cuda.synchronize()
        err = _same_raw(torch, name, k, p, PLAIN,
                        outs=("txp", "pos", "valid", "meta", "stamps"))
        _same_raw(torch, name, k[:4], bare, "the stampless launch's")
        del p, bare
        t = {False: [], True: []}
        for st in (False, True, True, False):
            t[st].append(_time_ms(
                torch, lambda: scan(lanes, tidx, stamps=st, **kw), 5))
        ms = {st: sum(v) / len(v) for st, v in t.items()}
        plain_ms = _time_ms(torch, lambda: mmp_scan_reference(
            lanes, tidx, stamps=True, **kw), 1) if time_plain else None
        stamp_bytes = n_lanes * 5 * 4
        bound = scan_bound(lanes, k[3], work, C, 4,
                           pos_bytes=tidx.pos_bits // 8,
                           extra_bytes=stamp_bytes)
        stamps = k[4].long()
        if C == 2:
            # the overflow stamp of a lane whose first overflow lies
            # inside a probe window, not at its end
            require(bool((stamps[:, 4] >= 0).any()),
                    f"{name}: no overflow was stamped")
        say(f"stamped kernel vs plain {name}: {n_lanes} lanes ({what} x "
            f"fwd/rc), all five raw outputs equal written over 0xFF "
            f"(stamps over {STAMP_FILL:#x}), the first four equal to the "
            f"stampless launch's; MMPs stamped "
            f"{int((stamps[:, :4] >= 0).sum())}, overflows stamped "
            f"{int((stamps[:, 4] >= 0).sum())}, latest stamp "
            f"{int(stamps.max())}; stamped {ms[True]:.3f} ms ({t[True][0]:.3f}"
            f", {t[True][1]:.3f}), stampless {ms[False]:.3f} ms "
            f"({t[False][0]:.3f}, {t[False][1]:.3f}), stamped / stampless "
            f"{ms[True] / ms[False]:.3f}; "
            + (f"plain {plain_ms:.3f} ms; " if time_plain else "")
            + f"bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} with "
            f"{stamp_bytes} bytes of stamps, stamped / bound "
            f"{ms[True] / bound['bound_ms']:.2f} [{card}]")
        out[name] = {"lanes": n_lanes, "ms": ms[True],
                     "ms_stampless": ms[False], "plain_ms": plain_ms,
                     "max_abs_err": err, **bound}
    return out, lanes, k


def cut_pass_check(torch, outs, width0, L, card):
    """The cut pass (map/shrink.py) at --scanShrink 2 over a first width
    of `width0` lanes, on the card against the CPU for the same stamped
    outputs: every lane's steps and the four cut outputs equal.  Returns
    the card's ms (CUDA events, 3 calls) and the lanes cut."""
    from sailfish_tpu_torch.map.shrink import apply_cut, cut_steps

    def cut(txp, pos, vld, meta, stamps):
        end = cut_steps(stamps, meta, width0=width0, shrink=2, max_steps=L)
        return (end, *apply_cut(txp, pos, vld, meta, stamps, end, C=64,
                                M=4))

    got = cut(*outs)
    want = cut(*(x.cpu() for x in outs))
    for what, a, b in zip(("steps", "txp", "pos", "valid", "meta"), got,
                          want):
        require(torch.equal(a.cpu(), b), f"cut pass: `{what}` on the card "
                "differs from the CPU's")
    ms = _time_ms(torch, lambda: cut(*outs), 3)
    n_cut = int((got[0] < outs[3][:, 3]).sum())
    lost = int((outs[3][:, 0] - got[4][:, 0]).sum())
    say(f"cut pass at --scanShrink 2, first width {width0}: "
        f"{outs[0].shape[0]} lanes, {n_cut} cut, {lost} MMPs dropped, equal "
        f"to the CPU's; {ms:.3f} ms on the card [{card}]")
    return ms, n_cut


def phase_shrink(torch, cli, wdir, idx_dir, idx15_dir, batches, kf, card,
                 copy_rate):
    """--scanShrink (phase 18 of the docstring).  Returns (the stamped
    launch's kernel row fields, launches by run)."""
    from sailfish_tpu_torch.index.builder import load_index
    from sailfish_tpu_torch.index.device import TorchIndex

    t_start = time.time()
    index = load_index(idx_dir)
    tidx = TorchIndex.from_quasi_index(index, "cuda")
    sample = _mate_reads(tuple(m[:kf] for m in batches[0]), True)
    kv, _, _ = stamped_vs_plain(
        torch, tidx, "sample", sample,
        [{"cand_cap": 64}, {"cand_cap": 64, "skip_jump": True},
         {"cand_cap": 2}], card, copy_rate)
    paired = _mate_reads(batches[0], False)
    kvp, lanes, outs = stamped_vs_plain(torch, tidx, "paired_batch", paired,
                                        [{"cand_cap": 64}], card, copy_rate,
                                        time_plain=True)
    kv.update(kvp)
    main = next(iter(kvp.values()))
    L = lanes["codes"].shape[1]
    cut_ms, n_cut = cut_pass_check(torch, outs[:5], lanes["codes"].shape[0],
                                   L, card)
    require(n_cut > 0, "cut pass: no lane of the paired batch was cut")
    del tidx, lanes, outs
    torch.cuda.empty_cache()
    tidx64 = TorchIndex.from_quasi_index(big_index(index), "cuda")
    kv.update(stamped_vs_plain(torch, tidx64, "sample64", sample,
                               [{"cand_cap": 64}], card, copy_rate)[0])
    del tidx64, index
    torch.cuda.empty_cache()
    tidx15 = TorchIndex.from_quasi_index(load_index(idx15_dir), "cuda")
    kv.update(stamped_vs_plain(torch, tidx15, "prefix_sample", sample,
                               [{"cand_cap": 64}, {"cand_cap": 2}], card,
                               copy_rate)[0])
    del tidx15
    torch.cuda.empty_cache()
    note("stamped kernel done")

    # the CLI on cuda against the CPU, on the first 2,048 fragments
    n = 2048
    paths = [os.path.join(wdir, f"reads_shrink_{i}.fq") for i in (1, 2)]
    for path, m in zip(paths, batches[0]):
        write_fastq(path, m[:n])
    argv = ["-l", "IU", "-1", paths[0], "-2", paths[1], "--dumpEq",
            "--batchSize", str(n), "--scanShrink", "2"]
    launches = {}
    _launch_counts(reset=True)
    out_g, _, _, _ = run_quant_cli(cli, wdir, idx_dir, "shrink2_cuda", argv,
                                   maps=True)
    lc = _launch_counts()
    launches["shrink2_2048"] = lc["mmp_scan_stamped"]
    require(lc["mmp_scan_stamped"] == lc["mmp_scan"] > 0,
            f"quant --scanShrink 2 launched {lc}: every launch stamped")
    out_c = os.path.join(wdir, "quant_shrink2_cpu")
    shutil.rmtree(out_c, ignore_errors=True)
    t0 = time.time()
    require(cli.main(["quant", "-i", idx_dir, "-o", out_c, "--hitCapacity",
                      "64", "--hitCapacityMax", "1024", *argv, "--device",
                      "cpu"]) == 0, "quant --scanShrink 2 --device cpu failed")
    cpu_s = time.time() - t0
    eq = [open(os.path.join(o, "aux", "eq_classes.txt")).read()
          for o in (out_g, out_c)]
    require(eq[0] == eq[1], "quant --scanShrink 2: eq_classes.txt on cuda "
            "differs from the CPU run's")
    sf = [open(os.path.join(o, "quant.sf")).read().splitlines()
          for o in (out_g, out_c)]
    cols = [[r.split("\t") for r in x] for x in sf]
    require(all(a[:3] == b[:3] for a, b in zip(*cols))
            and len(cols[0]) == len(cols[1]),
            "quant --scanShrink 2: quant.sf names or lengths differ")
    require(np.allclose(_quant_sf(out_g), _quant_sf(out_c), rtol=1e-5,
                        atol=0), "quant --scanShrink 2: quant.sf on cuda "
            "differs from the CPU run's beyond its 6 printed digits")
    same = "identical" if sf[0] == sf[1] else "equal to its printed digits"
    say(f"quant -l IU --scanShrink 2 on {n} fragments: eq_classes.txt "
        f"({int(eq[0].split(chr(10))[1])} classes) identical on cuda and "
        f"cpu, quant.sf {same}; stamped launches "
        f"{lc['mmp_scan_stamped']}; cpu run {cpu_s:.1f}s [{card}]")

    # phase 7's paired run (two production batches) again at --scanShrink
    # 2, beside that run's readings at 1: the second batch's ms is that of
    # a warm process
    paths = [os.path.join(wdir, f"reads_pe100_{i}.fq") for i in (1, 2)]
    B = batches[0][0].shape[0]
    _launch_counts(reset=True)
    t0 = time.time()
    _, meta, _, stats = run_quant_cli(
        cli, wdir, idx_dir, "shrink2_pe100",
        ["-l", "IU", "-1", paths[0], "-2", paths[1], "--batchSize", str(B),
         "--scanShrink", "2"], maps=True)
    wall = time.time() - t0
    lc = _launch_counts()
    require(lc["mmp_scan_stamped"] == lc["mmp_scan"] > 0,
            f"quant --scanShrink 2 launched {lc}: every launch stamped")
    launches["shrink2_pe100"] = lc["mmp_scan_stamped"]
    single = os.path.join(wdir, "quant_pe100")
    with open(os.path.join(single, "aux", "meta_info.json")) as fh:
        meta1 = json.load(fh)
    for shrink, m, st in ((1, meta1, _done_stats(single)),
                          (2, meta, stats)):
        qt = m["quant_timings"]
        say(f"quant -l IU --scanShrink {shrink} (pe100, "
            f"{m['num_processed']} fragments in batches of {B}): mapped "
            f"{m['num_mapped']} "
            f"({100.0 * m['num_mapped'] / m['num_processed']:.4f}%), "
            f"{st['num_eq_classes']} eq classes, "
            f"{qt['escalated_fragments']} escalated, batch ms "
            f"{qt['batch_ms']}"
            + (f", scan launches {lc['mmp_scan']} (stamped "
               f"{lc['mmp_scan_stamped']}), CLI wall {wall:.1f}s"
               if shrink == 2 else " (phase 7's run)") + f" [{card}]")
    say(f"shrink: phase took {time.time() - t_start:.1f}s")
    row = {"ms": main["ms"], "ms_stampless": main["ms_stampless"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"],
           "max_abs_err": max(v["max_abs_err"] for v in kv.values()),
           "cut_pass_ms": cut_ms, "shapes": kv}
    return row, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--txps", type=int, default=200_000)
    ap.add_argument("--bases", type=float, default=150e6)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--kernel-frags", type=int, default=8192)
    ap.add_argument("--oracle-frags", type=int, default=2048)
    ap.add_argument("--bench-reads", type=int, default=2_000_000,
                    help="fragments of the bench's gene-family run "
                    "(phase 16)")
    ap.add_argument("--bias-txps", type=int, default=2000,
                    help="transcripts of the card-against-CPU run of "
                    "update_effective_lengths")
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after the kernel comparison; no result line")
    ap.add_argument("--against", metavar="CHECKOUT", nargs="+",
                    help="time this tree's scan kernels in turns against "
                    "those of other checkouts of the repository (built "
                    "from their sources), one after the other, after the "
                    "toolchain and world phases; no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from sailfish_tpu_torch import cli
        from sailfish_tpu_torch.bench import (
            CheckFailure,
            oracle_check,
            stage_breakdown,
        )
        from sailfish_tpu_torch.index.builder import load_index, save_index
        from sailfish_tpu_torch.index.device import TorchIndex
        from sailfish_tpu_torch.parallel.shardidx import TorchShards
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script "
              f"({e})", file=sys.stderr)
        return 1
    try:
        phase_toolchain(torch)
        smi = nvidia_smi_line()
        copy_rate = phase_copy_bandwidth(torch, smi)
        kernels = ([] if args.kernel_only or args.against
                   else [phase_ubench(torch, smi)])
        note("ubench done")
        (idx_dir, idx4_dir, wdir, batches, long_batch, xl,
         seqs) = phase_world(args, cli)
        note("world ready")
        t0 = time.time()
        index = load_index(idx_dir)
        tidx = TorchIndex.from_quasi_index(index, "cuda")
        say(f"index on card: {tidx.n_text} text positions, 2^"
            f"{tidx.ht_bits} k-mer buckets, probe chain <= "
            f"{tidx.ht_probes} (load + upload {time.time() - t0:.1f}s)")
        kf, of = args.kernel_frags, args.oracle_frags
        if args.against:
            for n, path in enumerate(args.against):
                phase_in_turns(torch, load_other(path, f"other_sf{n}"),
                               index, tidx, idx4_dir, batches[0], kf, smi)
            say(smi)
            return 0
        # the lane blocks of the three runs below, whole and unchanged
        kv = {}
        main_case = [{"cand_cap": 64}]
        # the paired batch also under the jump rule: the lane block and
        # rule of the dist step's world 1 (phase 15)
        for tag, mates, cases in (
                ("paired_batch", batches[0],
                 main_case + [{"cand_cap": 64, "skip_jump": True}]),
                ("single_end_batch", batches[0][:1], main_case),
                ("long_batch", long_batch, main_case)):
            kv.update(phase_kernel_vs_plain(
                torch, tidx, tag, _mate_reads(mates, False), cases, smi,
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
        # the prefix route: the world's index at k = 15, without a table
        t0 = time.time()
        idx15 = prefix_index(index)
        tidx15 = TorchIndex.from_quasi_index(idx15, "cuda")
        say(f"k = {PREFIX_K} index of the world (from the k = 31 index's "
            f"arrays): P = {idx15.prefix_bases}, {tidx15.table_lo.numel()} "
            f"prefix-table entries, packed words on the card, no k-mer "
            f"table ({time.time() - t0:.1f}s)")
        kv15 = phase_kernel_vs_plain(
            torch, tidx15, "prefix_paired_batch",
            _mate_reads(batches[0], False), main_case, smi, copy_rate)
        kv15.update(phase_kernel_vs_plain(
            torch, tidx15, "prefix_sample",
            _mate_reads(tuple(m[:kf] for m in batches[0]), True),
            main_case + [{"cand_cap": 1024}, {"cand_cap": 2}], smi,
            copy_rate))
        small = _mate_reads(tuple(m[:kf // 4] for m in batches[0]), True)
        modes = [phase_modes_one_shard(torch, tidx15, small, smi)]
        # the prefix route in 64 bits: the scan against its plain version
        # and the 32-bit route, the modes against theirs
        t0 = time.time()
        tidx15_64 = TorchIndex.from_quasi_index(big_index(idx15), "cuda")
        say(f"64-bit k = {PREFIX_K} index on card: int64 suffix array, "
            f"offsets and prefix table ({time.time() - t0:.1f}s)")
        kv15.update(phase_kernel64(torch, tidx15, tidx15_64, (
            ("prefix64_sample",
             _mate_reads(tuple(m[:kf] for m in batches[0]), True),
             main_case + [{"cand_cap": 1024}, {"cand_cap": 2}]),),
            smi, copy_rate))
        modes.append(phase_modes_one_shard(torch, tidx15_64, small, smi))
        del tidx15_64
        torch.cuda.empty_cache()
        # the k = 15 index in shards, from the sharded index's arrays
        sidx = load_index(idx4_dir)
        rds15, launches_sh15 = phase_prefix_sharded(
            torch, tidx15, sidx, batches[0], small, smi)
        modes += rds15
        idx15_dir = os.path.join(wdir, f"index_k{PREFIX_K}")
        if not args.kernel_only:
            save_index(idx15, idx15_dir)
        del tidx15, idx15
        torch.cuda.empty_cache()
        note("prefix route done")
        # the sharded index: the modes, and the sharded map of the batch
        t0 = time.time()
        shards = TorchShards.from_sharded(sidx, ["cuda"])
        say(f"sharded index on card: {SHARDS} shards of "
            f"{[ix.n_text for ix in shards.indexes]} text positions "
            f"(load + upload {time.time() - t0:.1f}s)")
        kvs, rds = phase_sharded_kernels(torch, index, tidx, shards,
                                         batches[0], small, smi, copy_rate)
        modes += rds
        del shards, sidx
        torch.cuda.empty_cache()
        note("sharded kernels done")
        # the 64-bit instantiation on the big_sa layout of the same index
        t0 = time.time()
        tidx64 = TorchIndex.from_quasi_index(big_index(index), "cuda")
        say(f"64-bit index on card: {tidx64.n_text} text positions, int64 "
            f"suffix array and offsets, 2^{tidx64.ht_bits} table rows with "
            f"their side array of high words (cast + upload "
            f"{time.time() - t0:.1f}s)")
        paired_reads = _mate_reads(batches[0], False)
        kv64 = phase_kernel64(torch, tidx, tidx64, (
            ("paired_batch", paired_reads, main_case),
            ("single_end_batch", _mate_reads(batches[0][:1], False),
             main_case),
            ("long_batch", _mate_reads(long_batch, False), main_case),
            ("sample", _mate_reads(tuple(m[:kf] for m in batches[0]), True),
             main_case + [{"cand_cap": 1024}, {"cand_cap": 2}])),
            smi, copy_rate)
        phase_shifted(torch, index, tidx64, paired_reads, smi)
        modes.append(phase_modes_one_shard(torch, tidx64, small, smi))
        del tidx64, paired_reads
        torch.cuda.empty_cache()
        note("64-bit kernel done")
        if args.kernel_only:
            say(json.dumps({"scan_shapes": kv, "scan64_shapes": kv64,
                            "prefix_shapes": kv15, "sharded": kvs,
                            "mode_errs": mode_errs(*modes)}))
            say(smi)
            return 0
        sample = tuple(m[:of] for m in batches[0])
        ref_br = oracle_check(index, tidx, sample, "IU", (64, 2), out=say,
                              workers=ORACLE_WORKERS)
        oracle_check(index, tidx, (batches[0][0][:of],), "U", (64,), out=say,
                     workers=ORACLE_WORKERS)
        oracle_check(index, tidx, tuple(m[:of // 2] for m in long_batch),
                     "IU", (64,), out=say, workers=ORACLE_WORKERS)
        note("oracle done")
        profiled_ms = stage_breakdown(index, tidx, batches, smi, out=say)
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
            txp_lens=index.txp_lens[:nt].copy(), big_sa=False)
        whole = types.SimpleNamespace(
            codes=index.codes, txp_offsets=index.txp_offsets,
            txp_lens=index.txp_lens, big_sa=False)
        del tidx, index, ref_br
        torch.cuda.empty_cache()
        # the EM kernel's launches in each CLI run, one a solve
        em_launches = {}
        launches, em_launches["pe100"] = phase_end_to_end(
            torch, cli, wdir, idx_dir, "pe100", "IU",
            tuple(np.concatenate([b[i] for b in batches]) for i in (0, 1)),
            args.batch, smi)
        em_row = phase_em(torch, os.path.join(wdir, "quant_pe100"), smi)
        launches_se, em_launches["se100"] = phase_end_to_end(
            torch, cli, wdir, idx_dir, "se100", "U",
            (np.concatenate([b[0] for b in batches]),), args.batch, smi)
        launches_long, em_launches[f"pe{LONG_READ_LEN}"] = phase_end_to_end(
            torch, cli, wdir, idx_dir, f"pe{LONG_READ_LEN}", "IU",
            long_batch, args.batch, smi)
        note("end to end done")
        bias_outs, more_launches, bias_em = phase_bias_runs(
            torch, cli, wdir, idx_dir, args.batch, smi)
        em_launches.update(bias_em)
        phase_bias_update(torch, cut, whole, bias_outs, smi)
        note("bias done")
        phase_resume_samplers(torch, cli, wdir, idx_dir, smi)
        note("resume and samplers done")
        more_launches.update(phase_libraries_checkpoint(
            torch, cli, wdir, idx_dir, args.batch, smi))
        note("libraries and checkpoints done")
        launches64 = phase_big_cli(torch, cli, wdir, idx_dir, args.batch,
                                   smi)
        note("64-bit index CLI done")
        phase_launcher(torch, cli, wdir, idx_dir, args.batch, smi)
        note("launcher done")
        launches15 = phase_prefix_cli(torch, cli, wdir, idx15_dir, sample,
                                      smi)
        note("prefix CLI done")
        launches_sh = phase_sharded_cli(torch, cli, wdir, idx4_dir,
                                        args.batch, smi)
        note("sharded CLI done")
        torch.cuda.empty_cache()
        dist_launches, dist_prefix_launches = phase_dist(
            torch, idx_dir, batches[0], smi)
        note("dist done")
        torch.cuda.empty_cache()
        bench_launches = phase_bench(args, idx_dir, smi)
        note("bench done")
        capacity_launches, kv_capacity = phase_capacity(smi, copy_rate)
        kv.update(kv_capacity)
        note("capacity done")
        shrink_row, shrink_launches = phase_shrink(
            torch, cli, wdir, idx_dir, idx15_dir, batches, kf, smi,
            copy_rate)
        note("shrink done")
        require("jax" not in sys.modules
                and "sailfish_tpu" not in sys.modules,
                "jax or the JAX package was imported")
    except (SmokeFailure, CheckFailure) as e:
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
                            **more_launches, **dist_launches,
                            **bench_launches, **capacity_launches},
        "shapes": kv,
    })
    # the 64-bit instantiation: ms, plain_ms and bound_ms of the paired
    # batch's lanes on the big_sa index; launches of the CLI runs on it
    main64 = kv64[f"paired_batch_L{L100}_C64"]
    kernels.insert(1, {
        "name": "mmp_scan64", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "launches": launches64["pe100_64"],
        "max_abs_err": max(v["max_abs_err"] for v in kv64.values()),
        "ms": main64["ms"], "plain_ms": main64["plain_ms"],
        "bound_ms": main64["bound_ms"], "bound_by": main64["bound_by"],
        "library_ms": None, "ms_int32_same_lanes": main64["ms_int32"],
        "launches_by_run": launches64, "shapes": kv64,
    })
    # the prefix route: ms, plain_ms and bound_ms of the paired batch's
    # lanes on the k = 15 index; launches of the CLI run on that index
    main15 = kv15[f"prefix_paired_batch_L{L100}_C64"]
    kernels.insert(2, {
        "name": "mmp_scan_prefix", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "function_of": PREFIX_SEED,
        "launches": launches15["mmp_scan_prefix"],
        "max_abs_err": max(v["max_abs_err"] for v in kv15.values()),
        "ms": main15["ms"], "plain_ms": main15["plain_ms"],
        "bound_ms": main15["bound_ms"], "bound_by": main15["bound_by"],
        "library_ms": None, "chunks_read": main15["chunks_read"],
        "chunks_needed": main15["chunks_needed"], "shapes": kv15,
        "launches_by_run": {"pe_k15": launches15["mmp_scan_prefix"],
                            **dist_prefix_launches},
    })
    # the sharded modes: ms, plain_ms and bound_ms per launch on the
    # paired batch's lanes on the 4-shard index (facts and slots: the mean
    # over the shards, each in "per_launch"); max_abs_err over every
    # comparison with the plain version (both routes, both widths, the
    # sample, the escalation chunk, the paired batch); launches of the CLI
    # run on the sharded index
    errs = mode_errs(*modes)
    for n, (name, key) in enumerate((("mmp_facts", "facts"),
                                     ("mmp_replay", "replay_shards"),
                                     ("mmp_slots", "slots"))):
        kernels.insert(3 + n, {
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": TPU_KERNEL, "function_of": LOCKSTEP_SCAN,
            "launches": launches_sh[name], "max_abs_err": errs[key],
            "ms": kvs[key]["ms"], "plain_ms": kvs[key]["plain_ms"],
            "bound_ms": kvs[key]["bound_ms"],
            "bound_by": kvs[key]["bound_by"], "library_ms": None,
            # facts: chunks read and needed over the paired batch's
            # launches, each launch's in per_launch
            **({c: sum(x[c] for x in kvs[key]["per_launch"])
                for c in ("chunks_read", "chunks_needed")}
               if key == "facts" else {}),
            "per_launch": kvs[key]["per_launch"],
        })
    # the replay: the top-level numbers and launches are the shards
    # mode's, which the k-mer route's CLI run launched (the plane mode
    # counted apart; its launch on the main path is the sharded map at
    # k = 15); each mode's own in "modes", the shards mode beside the
    # torch merge that it replaced
    rep = next(x for x in kernels if x["name"] == "mmp_replay")
    rep["launches"] = (launches_sh["mmp_replay_shards"]
                       + launches_sh["mmp_replay"])
    rep["modes"] = {
        mode: {"launches": launches, "max_abs_err": errs[key],
               **{f: kvs[key][f] for f in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")},
               "per_launch": kvs[key]["per_launch"]}
        for mode, key, launches in (
            ("shards", "replay_shards", launches_sh["mmp_replay_shards"]),
            ("plane", "replay", launches_sh15["mmp_replay"]))}
    rep["modes"]["shards"]["torch_merge_ms"] = kvs["replay_shards"][
        "merge_ms"]
    rep["launches_by_run"] = {
        "sharded_kmer_cli": launches_sh["mmp_replay_shards"],
        f"sharded_k{PREFIX_K}_map": launches_sh15["mmp_replay"]}
    # the scan's stamped launch (--scanShrink): ms, plain_ms and bound_ms
    # of the paired batch's lanes; launches of the paired run at N = 2
    kernels.insert(6, {
        "name": "mmp_scan_stamped", "route": "cuda", "source": KERNEL_SRC,
        "replaces": TPU_KERNEL, "function_of": SHRINK_SCAN,
        "launches": shrink_launches["shrink2_pe100"],
        "library_ms": None, **shrink_row,
        "launches_by_run": shrink_launches})
    # the EM kernel's launches are those of the CLI runs (the main
    # path), not of phase_em's own solves
    kernels.append({**em_row, "launches": em_launches["pe100"],
                    "launches_by_run": em_launches})
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
