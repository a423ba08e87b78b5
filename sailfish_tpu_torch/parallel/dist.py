"""Multi-device execution: data-parallel read mapping + collective merge.

Counterpart of sailfish_tpu/parallel/dist.py.  The index is replicated
per rank, a paired batch is split over the ranks, and each rank's
partial statistics are summed over the process group; the abundance
update then runs on the merged state, the same on every rank.

Where the JAX package jits one `shard_map` over a device mesh, the port
runs one process per rank (`spawn` on one host, or any launcher that
sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT), a process group
(`make_mesh`: NCCL on `cuda`, gloo on `cpu`, or gloo on a card that
several ranks share) and `torch.distributed.all_reduce(op=SUM)` in place
of `jax.lax.psum(..., "data")`.

`distributed_quant_step` is the per-batch step:

  1. each rank takes its contiguous rows of the batch (`P("data")`) and
     maps both mates in one lane block through map/lanes.py (lanes, the
     scan: the CUDA kernel on a card, then the post-pass), in the route
     that `use_hash` names
  2. merge/compat/label-form per fragment (map/pair.py)
  3. the per-fragment EM accumulation (`_fragment_em_update`), the FLD
     histogram, the mapped count and the hashed eq-class count table
     (`eq_hash_count_table`) of its rows
  4. two all_reduces, in this order on every rank: the float32 partial
     alpha, then one int64 vector holding the FLD, the mapped count and
     the table's counts and h2 sums (the JAX step's four integer psums
     in one collective; integer sums are exact, so the result is the
     same)

The step scans under the jump rule (`skip_jump`), as the JAX step does:
it leaves map_oriented_lanes' `skip_jump=True` default in place, while
the CLI's default rule is "nip" (config.py `mmp_skip`).

    python -m sailfish_tpu_torch.parallel.dist --world N [--device cuda|cpu]
        [--backend nccl|gloo]

runs one step on a synthetic world in N ranks on this host and checks it
as the JAX package's `dryrun_multichip` does (__graft_entry__.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..config import QuantOpts
from ..device import as_device, synchronize
from ..index.builder import QuasiIndex, build_index, load_index
from ..index.device import TorchIndex
from ..libformat import parse_library_format
from ..map.lanes import map_oriented_lanes
from ..map.pair import merge_and_collapse
from ..map.pipeline import fmt_args as library_fmt_args

# the JAX step calls map_oriented_lanes without `skip_jump`, whose
# default there is True
_SKIP_JUMP = True
EQ_BITS = 16     # slots of the hashed eq-class table: 2^EQ_BITS


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel world."""
    rank: int
    size: int
    device: torch.device
    group: object           # the torch.distributed process group
    backend: str

    def close(self) -> None:
        """Destroy the process group `make_mesh` started."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: int | None = None, axis: str = "data", *,
              device="cuda", backend: str | None = None) -> Mesh:
    """Start this rank's process group of `n_devices` ranks (WORLD_SIZE
    when None): from RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, or,
    for a world of one with none of them set, in this process alone.
    `axis` is the JAX mesh's axis name, taken and unused: the ranks form
    one data axis.

    The backend is NCCL on `cuda`, where rank r takes card r (LOCAL_RANK
    when set), and gloo on `cpu`; `backend="gloo"` on `cuda` puts every
    rank on the one card named (several ranks sharing a card, which NCCL
    refuses).  Raises ValueError when the ranks ask for more cards than
    there are, and as_device's error for `cuda` without one; it never
    moves a rank to another device type."""
    want = torch.device(device)
    backend = backend or ("nccl" if want.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and want.type != "cuda":
        raise ValueError(f"NCCL needs cuda devices (got {want})")
    if dist.is_initialized():
        raise ValueError("this process has a process group already")
    size = int(os.environ.get("WORLD_SIZE", n_devices or 1))
    rank = int(os.environ.get("RANK", 0))
    n = n_devices or size
    if n != size:
        raise ValueError(f"the mesh wants {n} ranks, WORLD_SIZE is {size}")
    dev = as_device(want)
    if backend == "nccl":
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"need {n} devices, have {have}")
        if want.index is not None and n > 1:
            raise ValueError(f"NCCL ranks need distinct cards; {want} names "
                             "one (pass 'cuda')")
        dev = torch.device("cuda", want.index if want.index is not None
                           else int(os.environ.get("LOCAL_RANK", rank)))
    if "MASTER_ADDR" in os.environ:
        init = dict(init_method="env://")
    elif size == 1:
        init = dict(store=dist.HashStore())
    else:
        raise ValueError(f"a world of {size} ranks needs MASTER_ADDR and "
                         "MASTER_PORT (spawn() sets them)")
    extra = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=size, **init,
                            **extra)
    return Mesh(rank=rank, size=size, device=dev, group=dist.group.WORLD,
                backend=backend)


def _fragment_em_update(label, label_len, alpha, eff_lens, num_txps: int):
    """Uncollapsed EM accumulation over per-fragment labels.

    label: (B, W) int32 member txp ids, PAD=-1 beyond label_len.
    Returns this rank's partial alphaOut (num_txps,) float32, before the
    all_reduce.

    A PAD slot adds exactly 0.0, as in the JAX update, but to bin
    (slot number mod num_txps) rather than to bin 0: most of the W = 4C
    slots are PAD, and on a card their atomic adds, all on one bin,
    took most of the update's time (PERF.md §6)."""
    valid = label >= 0
    spread = torch.arange(label.numel(), device=label.device).view(
        label.shape) % num_txps
    safe = torch.where(valid, label.long(), spread)
    zero = torch.zeros((), dtype=torch.float32, device=label.device)
    one = torch.ones((), dtype=torch.float32, device=label.device)
    inv_el = 1.0 / torch.clamp(eff_lens.float(), min=1.0)
    w = torch.where(valid, inv_el[safe], zero)      # un-normalized 1/effLen
    wsum = w.sum(dim=1, keepdim=True)
    w = torch.where(wsum > 0, w / torch.where(wsum > 0, wsum, one), zero)
    av = torch.where(valid, alpha.float()[safe], zero) * w
    denom = av.sum(dim=1, keepdim=True)
    singleton = label_len[:, None] == 1
    contrib = torch.where(
        singleton,
        torch.where(valid, one, zero),
        torch.where(denom > 0, av / torch.where(denom > 0, denom, one), zero),
    )
    out = torch.zeros(num_txps, dtype=torch.float32, device=label.device)
    return out.index_add_(0, safe.reshape(-1), contrib.reshape(-1))


def _eq_hash_sums(h1, h2, mapped, bits: int = EQ_BITS):
    """The hashed table's count and h2 sum per slot, int64 and unwrapped
    (they add across ranks without overflow)."""
    mask = (1 << bits) - 1
    slot = torch.where(mapped, h1.long() & mask, 0)
    counts = torch.zeros(1 << bits, dtype=torch.int64, device=h1.device)
    sums = torch.zeros_like(counts)
    counts.index_add_(0, slot, mapped.long())
    sums.index_add_(0, slot, torch.where(mapped, h2.long(), 0))
    return counts, sums


def _wrap32_t(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def eq_hash_count_table(h1, h2, mapped, *, bits: int = EQ_BITS):
    """Fixed-shape eq-class count table for cross-rank merging.

    Each mapped fragment's 64-bit label hash (h1, h2: int64 tensors
    holding uint32, the dual hash the host accumulator keys on,
    map/pair.py) indexes a 2^bits-slot table by its low bits; summing
    the tables over the ranks merges class counts without moving
    variable-length labels.  Returns (counts[2^bits] int32,
    checksum[2^bits] int32): the checksum slot holds the sum of its
    occupants' h2 mod 2^32, so collisions are detectable by the caller
    (`collision_suspect_slots`).  Unmapped fragments (h1 = h2 =
    0xFFFFFFFF) count nowhere."""
    counts, sums = _eq_hash_sums(h1, h2, mapped, bits)
    return _wrap32_t(counts), _wrap32_t(sums)


def _wrap32(x) -> np.ndarray:
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(
        np.int32
    )


def expected_eq_table(h1, h2, counts, *, bits: int = EQ_BITS):
    """Host-side ground-truth table from exact per-CLASS (h1, h2, count)
    triples (numpy, int32 wraparound) — what eq_hash_count_table's
    per-fragment accumulation must equal, label by label."""
    size = 1 << bits
    ct = np.zeros(size, np.int64)
    ck = np.zeros(size, np.int64)
    slot = np.asarray(h1, np.int64) & (size - 1)
    np.add.at(ct, slot, np.asarray(counts, np.int64))
    np.add.at(
        ck, slot,
        _wrap32(h2).astype(np.int64) * np.asarray(counts, np.int64),
    )
    return ct.astype(np.int32), _wrap32(ck)


def collision_suspect_slots(counts, checksum, rep_h2) -> np.ndarray:
    """The checksum detection path: slots whose accumulated h2 checksum
    is inconsistent with single-label occupancy at the representative
    h2 (checksum must equal wrap32(count * rep_h2)) — any mismatch
    proves two distinct labels share the slot (a low-bits h1
    collision), telling the caller to fall back to the exact host-side
    label merge for those classes."""
    counts = np.asarray(counts, np.int64)
    exp = _wrap32(counts * _wrap32(rep_h2).astype(np.int64))
    return np.nonzero((counts > 0) & (np.asarray(checksum) != exp))[0]


def fld_histogram(frag_len, unique_paired, max_frag_len: int):
    """(max_frag_len,) int64 histogram of the unique-paired fragments'
    lengths below max_frag_len, as the JAX step's `jnp.bincount`: a
    negative length counts in bin 0."""
    fl = torch.where(unique_paired & (frag_len < max_frag_len), frag_len,
                     max_frag_len).long().clamp(min=0)
    return torch.bincount(fl, minlength=max_frag_len + 1)[:max_frag_len]


def _step_index(text, device, use_hash: bool) -> TorchIndex:
    """The index the step scans, on `device`: a TorchIndex as given, or
    a QuasiIndex uploaded in the route `use_hash` names (without its
    k-mer table when use_hash is False, so the prefix table seeds, as
    the JAX step's `text` does).  Raises ValueError when the route
    cannot be had."""
    if isinstance(text, QuasiIndex):
        if use_hash and text.kmer_ht is None:
            raise ValueError("use_hash=True needs an index with a k-mer "
                             f"table (k = {text.k} has none)")
        if not use_hash and text.kmer_ht is not None:
            text = dataclasses.replace(text, kmer_ht=None)
        return TorchIndex.from_quasi_index(text, device)
    if not isinstance(text, TorchIndex):
        raise TypeError(f"the step takes a QuasiIndex or a TorchIndex, not "
                        f"{type(text).__name__}")
    if text.device != device:
        raise ValueError(f"the index is on {text.device}, the rank on "
                         f"{device}")
    if use_hash == text.prefix_route:
        raise ValueError(
            f"use_hash={use_hash} but the TorchIndex "
            f"{'has no' if text.prefix_route else 'has a'} k-mer table; "
            "pass the host QuasiIndex to upload the other route")
    return text


def _rows(x, rows: slice, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x)[rows].to(device=device, dtype=dtype)


def distributed_quant_step(
    mesh: Mesh,
    text,
    eff_lens,
    *,
    k: int,
    prefix_bases: int,
    cand_cap: int = 32,
    max_mmps: int = 4,
    max_steps: int = 8,
    max_frag_len: int = 1000,
    fmt_args=None,
    opts=None,
    use_hash: bool = False,
    ht_probes: int = 0,
    ht_bits: int = 0,
):
    """Build this rank's per-batch step.  `text` is the index: a
    TorchIndex on the rank's device, or the host QuasiIndex it is
    uploaded from; k, prefix_bases, ht_probes and ht_bits must be the
    scanned index's (ValueError otherwise).

    Returns fn(codes1, lens1, codes2, lens2, alpha) ->
      (alpha_out, fld_hist, num_mapped, eq_counts, eq_checksum), the
    same on every rank: alpha_out (T,) float32, fld_hist
    (max_frag_len,) int64, num_mapped a 0-dim int64, eq_counts and
    eq_checksum (2^16,) int32 (the merged hashed eq-class count table,
    see eq_hash_count_table).  fn takes the whole batch, (B, L) uint8
    codes and (B,) lengths of both mates (numpy or tensors on any
    device), and maps rank r's rows [r B / n, (r + 1) B / n); B must be
    a multiple of the world's size."""
    opts = opts or QuantOpts()
    if fmt_args is None:
        fmt_args = library_fmt_args(parse_library_format(opts.lib_type))
    orient, strand, se_flags = fmt_args
    dev = mesh.device
    index = _step_index(text, dev, use_hash)
    for name, got, have in (("k", k, index.k),
                            ("prefix_bases", prefix_bases,
                             index.prefix_bases),
                            ("ht_probes", ht_probes, index.ht_probes),
                            ("ht_bits", ht_bits, index.ht_bits)):
        if got != have:
            raise ValueError(f"{name}={got} but the index has {have}")
    eff = torch.as_tensor(eff_lens).to(device=dev, dtype=torch.float32)
    num_txps = int(eff.shape[0])
    scan_kw = dict(cand_cap=cand_cap, max_mmps=max_mmps, max_steps=max_steps,
                   skip_jump=_SKIP_JUMP)

    def part(d, sl):
        return {kk: v[sl] for kk, v in d.items() if kk != "num_mapped_loci"}

    def step(codes1, lens1, codes2, lens2, alpha):
        B = int(codes1.shape[0])
        if B % mesh.size:
            raise ValueError(f"a batch of {B} fragments does not split over "
                             f"{mesh.size} ranks")
        b = B // mesh.size
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        c1 = _rows(codes1, rows, torch.uint8, dev)
        c2 = _rows(codes2, rows, torch.uint8, dev)
        l1 = _rows(lens1, rows, torch.int32, dev)
        l2 = _rows(lens2, rows, torch.int32, dev)
        a = torch.as_tensor(alpha).to(device=dev, dtype=torch.float32)
        # both mates in one lane block, rows [m1; m2] x [fwd; rc]; the
        # narrower mate is padded with code 4 behind its reads' lengths
        codes = torch.full((2 * b, max(c1.shape[1], c2.shape[1])), 4,
                           dtype=torch.uint8, device=dev)
        codes[:b, :c1.shape[1]] = c1
        codes[b:, :c2.shape[1]] = c2
        hits = map_oriented_lanes(index, codes, torch.cat([l1, l2]),
                                  **scan_kw)
        h1 = part(hits, slice(0, b)), part(hits, slice(2 * b, 3 * b))
        h2 = part(hits, slice(b, 2 * b)), part(hits, slice(3 * b, 4 * b))
        out = merge_and_collapse(
            h1[0], h1[1], h2[0], h2[1], l1, l2, orient, strand, se_flags,
            paired_end=True,
            cand_cap=cand_cap,
            max_read_occs=opts.max_read_occs,
            allow_orphans=opts.allow_orphans,
            allow_dovetail=opts.allow_dovetail,
            ignore_compat=opts.ignore_lib_compat,
            enforce_compat=opts.enforce_lib_compat,
            strict_intersect=opts.strict_intersect,
        )
        alpha_out = _fragment_em_update(out["label"], out["label_len"], a,
                                        eff, num_txps)
        fld = fld_histogram(out["frag_len"], out["unique_paired"],
                            max_frag_len)
        counts, sums = _eq_hash_sums(out["h1"], out["h2"], out["mapped"])
        ints = torch.cat([fld, out["mapped"].sum().long()[None], counts,
                          sums])
        dist.all_reduce(alpha_out, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(ints, op=dist.ReduceOp.SUM, group=mesh.group)
        fld, n_mapped, counts, sums = ints.split(
            [max_frag_len, 1, counts.numel(), sums.numel()])
        return alpha_out, fld, n_mapped[0], _wrap32_t(counts), _wrap32_t(sums)

    return step


# ---------------------------------------------------------------- ranks
def _free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, backend, threads, fn, args, out):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    # the ranks of one host meet on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = make_mesh(world, device=device, backend=backend)
        try:
            res = fn(mesh, *args)
        finally:
            mesh.close()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, *args, device="cuda", backend: str | None = None,
          threads: int | None = None, timeout: float = 900.0) -> list:
    """Run fn(mesh, *args) in `world` new processes on this host, one per
    rank, each in a process group of `world` ranks met at 127.0.0.1 on a
    free port (`make_mesh` with `device` and `backend`); returns their
    results in rank order.  `fn` must be importable from a module, and
    its arguments and result picklable.  `threads` sets each rank's
    torch threads.  Raises RuntimeError with the rank's traceback when a
    rank fails, dies or outlasts `timeout` seconds; every rank is ended
    before it returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world, port, str(device), backend,
                               threads, fn, args, out))
             for r in range(world)]
    results: dict = {}
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
            except queue.Empty:
                # a rank that returns puts its result first and exits 0;
                # another exit code is a crash
                dead = [p.name for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"{', '.join(dead)} exited without "
                                       "a result") from None
                if time.time() > deadline:
                    raise RuntimeError(f"the ranks outlasted {timeout} s") \
                        from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{res}")
            results[rank] = res
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=30 if len(results) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world)]


def _scan_launches() -> dict:
    return {k: trace.counter("launch." + k)
            for k in ("mmp_scan", "mmp_scan_prefix")}


def run_step(mesh: Mesh, text, eff_lens, batch, alpha, step_kw: dict,
             reps: int = 1) -> dict:
    """One rank's part of a spawned step: builds the step on `text` (an
    index, or an index directory, which this rank loads), puts the whole
    batch (codes1, lens1, codes2, lens2) on the rank's device and runs
    the step `reps` times.  Returns the last run's outputs as numpy
    arrays, the milliseconds of each run (host clock, the device
    synchronized and the ranks at a barrier before it, the device
    synchronized after) and the scan kernels' launches in these runs."""
    if isinstance(text, str):
        text = load_index(text)
    step = distributed_quant_step(mesh, text, eff_lens, **step_kw)
    c1, l1, c2, l2 = (torch.as_tensor(x).to(mesh.device) for x in batch)
    before = _scan_launches()
    ms = []
    for _ in range(reps):
        synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        res = step(c1, l1, c2, l2, alpha)
        synchronize(mesh.device)
        ms.append(1e3 * (time.perf_counter() - t0))
    after = _scan_launches()
    alpha_out, fld, n_mapped, eq_counts, eq_check = (
        t.cpu().numpy() for t in res)
    return {"alpha": alpha_out, "fld": fld, "num_mapped": int(n_mapped),
            "eq_counts": eq_counts, "eq_checksum": eq_check, "ms": ms,
            "launches": {kk: after[kk] - before[kk] for kk in after}}


def same_on_every_rank(results: list) -> dict:
    """The first rank's outputs, after checking that every rank returned
    the same ones (integers exactly, alpha at rtol 1e-6)."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        for key in ("fld", "eq_counts", "eq_checksum"):
            if not np.array_equal(res[key], first[key]):
                raise RuntimeError(f"rank {r}'s {key} differs from rank 0's")
        if res["num_mapped"] != first["num_mapped"] or not np.allclose(
                res["alpha"], first["alpha"], rtol=1e-6, atol=0):
            raise RuntimeError(f"rank {r}'s outputs differ from rank 0's")
    return first


# ---------------------------------------------------------------- dryrun
def _synthetic_world(num_txps=32, txp_len=400, seed=0):
    """Random transcripts and their k = 31 index (the port's copy of
    __graft_entry__.py `_synthetic_world`)."""
    rng = np.random.default_rng(seed)
    seqs = [
        rng.integers(0, 4, txp_len + 16 * (i % 5)).astype(np.uint8)
        for i in range(num_txps)
    ]
    names = [f"t{i}" for i in range(num_txps)]
    return build_index(names, seqs, k=31), seqs


def _sim_pe(seqs, n, readlen=50, seed=1):
    """n error-free paired fragments (the port's copy of
    __graft_entry__.py `_sim_pe`)."""
    from .. import dna

    rng = np.random.default_rng(seed)
    L = (readlen + 7) // 8 * 8
    c1 = np.full((n, L), 4, np.uint8)
    c2 = np.full((n, L), 4, np.uint8)
    lens = np.full(n, readlen, np.int32)
    for i in range(n):
        t = int(rng.integers(0, len(seqs)))
        s = seqs[t]
        fl = int(rng.integers(readlen + 20, min(300, len(s))))
        p = int(rng.integers(0, len(s) - fl + 1))
        frag = s[p : p + fl]
        c1[i, :readlen] = frag[:readlen]
        c2[i, :readlen] = dna.revcomp(frag[-readlen:])
    return c1, c2, lens


def host_classes(index: QuasiIndex, opts: QuantOpts, device, batch,
                 tindex: TorchIndex | None = None):
    """The exact eq classes of `batch` (codes1, lens1, codes2, lens2)
    from the device backend's fast path (map/pipeline.py
    `finish_batch_fast`, library IU): (h1s, h2s, counts) per class, the
    accumulator's 64-bit keys split into their halves."""
    from ..io.fastq import FastqBatch
    from ..map.pipeline import DeviceMapperBackend

    c1, l1, c2, l2 = batch
    host = DeviceMapperBackend(index, opts, device, tindex=tindex)
    acc = host.accumulator()
    tok = host.submit_pe(FastqBatch(c1, l1), FastqBatch(c2, l2),
                         parse_library_format("IU"))
    host.finish_batch_fast(tok, acc)
    keys, counts = acc.keyed_counts()
    return ((keys >> np.uint64(32)).astype(np.uint32),
            (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32), counts)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def check_step(res: dict, h1s, h2s, counts) -> int:
    """The checks of the JAX package's dryrun_multichip on one step's
    merged outputs `res` (run_step's dict), against the exact classes of
    the same batch: alpha sums to the mapped count within 1 %, the table
    covers every mapped fragment and equals expected_eq_table slot for
    slot, and the collision detector is silent on single-label slots
    and fires on a corrupted representative.  Returns the number of
    occupied slots; raises RuntimeError on a failed check."""
    alpha, n_mapped = res["alpha"], res["num_mapped"]
    eq_counts, eq_check = res["eq_counts"], res["eq_checksum"]
    _require(n_mapped > 0, "the step mapped nothing")
    _require(abs(float(alpha.sum(dtype=np.float64)) - n_mapped)
             < 1e-2 * max(n_mapped, 1),
             f"alpha sums to {alpha.sum()}, {n_mapped} fragments mapped")
    _require(int(eq_counts.sum()) == n_mapped,
             f"the eq table holds {eq_counts.sum()} of {n_mapped} fragments")
    exp_ct, exp_ck = expected_eq_table(h1s, h2s, counts)
    _require(np.array_equal(exp_ct, eq_counts),
             "eq table counts diverge from the host label-by-label table")
    _require(np.array_equal(exp_ck, eq_check),
             "eq table checksums diverge from the host label-by-label table")
    size = len(eq_counts)
    slot = h1s.astype(np.int64) & (size - 1)
    rep_h2 = np.zeros(size, np.int64)
    rep_h2[slot] = h2s
    occupied = np.nonzero(eq_counts > 0)[0]
    single = [s for s in occupied if (slot == s).sum() == 1]
    sus = collision_suspect_slots(eq_counts, eq_check, rep_h2)
    _require(not set(single) & set(sus.tolist()),
             "collision detector false positive on single-label slots")
    if single:
        corrupt = rep_h2.copy()
        corrupt[single[0]] ^= 0x5A5A
        _require(single[0] in collision_suspect_slots(
            eq_counts, eq_check, corrupt).tolist(),
            "collision detector failed to fire")
    return len(occupied)


def dryrun(world: int, device="cuda", backend: str | None = None,
           threads: int | None = None) -> dict:
    """One data-parallel step of `world` spawned ranks on the synthetic
    world of __graft_entry__.py `dryrun_multichip` (32 transcripts of
    350+ bases, 64 paired fragments per rank), checked by `check_step`
    against the device backend's classes on this process's `device`.
    Returns the summary that the entry point prints."""
    dev = as_device(device)
    if dev.type == "cpu" and threads is None:
        threads = 1      # the ranks share the host's cores
    if dev.type == "cuda":
        from .. import _ext

        _ext.load()      # built once here, not by every rank
    idx, seqs = _synthetic_world(num_txps=32, txp_len=350)
    eff = np.maximum(idx.txp_lens.astype(np.float64) - 180.0,
                     1.0).astype(np.float32)
    use_hash = idx.kmer_ht is not None
    step_kw = dict(
        k=idx.k, prefix_bases=idx.prefix_bases, cand_cap=16, max_mmps=2,
        max_steps=4, use_hash=use_hash,
        ht_probes=int(idx.kmer_ht["max_probes"]) if use_hash else 0,
        ht_bits=int(idx.kmer_ht["ht_bits"]) if use_hash else 0)
    B = 64 * world
    c1, c2, lens = _sim_pe(seqs, B, seed=2)
    alpha0 = np.full(idx.num_transcripts, float(B) / idx.num_transcripts,
                     np.float32)
    batch = (c1, lens, c2, lens)
    results = spawn(run_step, world, idx, eff, batch, alpha0, step_kw, 2,
                    device=device, backend=backend, threads=threads)
    res = same_on_every_rank(results)
    host_opts = QuantOpts(hit_capacity=16, hit_capacity_max=0, max_mmps=2,
                          max_scan_steps=4)
    h1s, h2s, counts = host_classes(idx, host_opts, dev, batch)
    slots = check_step(res, h1s, h2s, counts)
    return {"world": world,
            "backend": backend or ("nccl" if dev.type == "cuda" else "gloo"),
            "device": str(device), "fragments": B,
            "n_mapped": res["num_mapped"], "classes": len(counts),
            "eq_slots": slots,
            "alpha_sum": float(res["alpha"].sum(dtype=np.float64)),
            # the second step's, after the first has loaded the kernels
            "step_ms": max(r["ms"][-1] for r in results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sailfish_tpu_torch.parallel.dist",
        description="One data-parallel quantification step on a synthetic "
        "world, in N ranks on this host, checked against the device "
        "backend's eq classes.")
    ap.add_argument("--world", type=int, required=True,
                    help="ranks (processes) to spawn")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)
    if args.world < 1:
        ap.error("--world must be at least 1")
    try:
        summary = dryrun(args.world, args.device, args.backend)
    except (RuntimeError, ValueError) as e:
        print(f"dist: {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
