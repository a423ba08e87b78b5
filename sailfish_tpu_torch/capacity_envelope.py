"""Hit-capacity envelope: ``python -m sailfish_tpu_torch.capacity_envelope``.

Counterpart of tools/capacity_envelope.py (docs/PARITY.md #2).  The
reference enumerates every suffix-array candidate of an MMP before the
--maxReadOcc 200 filter; the device path caps the candidates of a probe
at --hitCapacity (64), sends the fragments that overflow through an
escalation pass at --hitCapacityMax, and drops those that overflow
again.  Two modes measure what that cap costs:

  --mode probe    (the default) on the gene-family world of the bench
                  (`bench.gencode_world`: --txps, --bases, --index-dir,
                  --cache) and --frags paired fragments of read seed 99:
                  the widest exact-k interval each fragment's probes
                  meet (`ProbeSizeMapper`) and its unbounded mapping by
                  the numpy reference mapper.  For each of --caps
                  (64,256,1024): the share of fragments with an interval
                  wider than the cap, and those the reference keeps
                  (mapped, at most 200 loci) that the cap drops.  This
                  mode walks the reference mapper on the host and
                  launches nothing.
  --mode repeat   a 300 bp element planted in 10 % of 4,000 random
                  transcripts (`repeat_world`, numpy seed 5), so that
                  reads inside it meet exact-k intervals of about 400,
                  and --frags (2,048) paired fragments mapped by the
                  device backend at --hitCapacity 64 and each
                  --hitCapacityMax of --caps (256,2048): the fragments
                  mapped at the widest cap and dropped at a narrower one.
                  Its world is fixed and built in memory: it takes none
                  of the world flags.
                  Runs on the CUDA card unless --device cpu asks for the
                  CPU (the kernels' plain versions); without a card the
                  default fails with device.py `as_device`'s error.

stdout holds one JSON line with the JAX tool's keys and values; repeat
mode adds `escalated_cap{c}` (fragments sent to the wide pass),
`element_interval` (the widest exact-k interval of the world: the
planted element's first 100 bases), the device and the card's name and
power limit (nvidia-smi).  The narrative goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np

from . import dna
from .bench import (
    DEFAULT_CACHE,
    WORLD_FLAGS,
    add_world_flags,
    gencode_world,
    log,
    simulate_batch,
)
from .config import QuantOpts
from .device import as_device
from .index.builder import QuasiIndex, build_index
from .index.device import TorchIndex
from .io.fastq import FastqBatch
from .libformat import parse_library_format
from .map.pipeline import BatchResult, DeviceMapperBackend
from .refimpl.mapper import RefMapper
from .ubench import card_line

MODES = {"probe": dict(frags=5000, caps="64,256,1024"),
         "repeat": dict(frags=2048, caps="256,2048")}
UNBOUNDED = QuantOpts(hit_capacity=10**9, hit_capacity_max=10**9)
# the repeat world: its transcripts, the element, the share that holds it
REPEAT_TXPS, REPEAT_TXP_LEN, ELEMENT_LEN, PLANT_P = 4000, 1000, 300, 0.10
REPEAT_READ_LEN, REPEAT_L = 100, 104


class ProbeSizeMapper:
    """The reference mapper's MMP scan with unbounded candidates, which
    records the widest exact-k suffix-array interval it probes."""

    def __init__(self, index: QuasiIndex, opts: QuantOpts):
        self.ref = RefMapper(index, opts)
        self.ref.cand_cap = None  # unbounded
        self.idx = index
        self.opts = opts

    def max_interval(self, read) -> int:
        """Largest exact-k-mer SA interval over the probed positions of
        the NIP scan (both the probes that hit and those that miss on
        true codes)."""
        idx, opts, ref = self.idx, self.opts, self.ref
        k, P = idx.k, idx.prefix_bases
        L = len(read)
        i = steps = mx = nm = 0
        budget = opts.effective_scan_steps(L)
        while i + k <= L and steps < budget and nm < opts.max_mmps:
            steps += 1
            window = read[i:i + P]
            if np.any(window >= 4):
                i += 1
                continue
            lo, hi = idx.prefix_interval(window)
            if hi <= lo:
                i += 1
                continue
            cand = np.asarray(ref._sa[lo:hi], dtype=np.int64)
            a_lcps = np.array([ref._asub_lcp(read, i, g) for g in cand])
            cand = cand[a_lcps >= k]
            mx = max(mx, len(cand))
            if len(cand) == 0:
                i += 1
                continue
            lstar = max(ref._lcp(read, i, g) for g in cand)
            if lstar < k:
                i += 1
                continue
            nm += 1
            i += max(1, lstar - k + 1)
        return mx


# ---------------------------------------------------------------- probe
def run_probe(args) -> dict:
    """Probe mode: per fragment the widest interval over both mates in
    both orientations, and its unbounded mapping (label length, 0 when
    unmapped)."""
    index, concat, offs, lens, _ = gencode_world(args)
    c1, c2 = simulate_batch(np.random.default_rng(99), concat, offs, lens,
                            args.frags)
    pm = ProbeSizeMapper(index, UNBOUNDED)
    expected = parse_library_format("IU")
    maxint = np.zeros(args.frags, np.int64)
    occ = np.zeros(args.frags, np.int64)
    mapped = np.zeros(args.frags, bool)
    t0 = time.time()
    for f, (m1, m2) in enumerate(zip(c1, c2)):
        maxint[f] = max(pm.max_interval(r) for r in (
            m1, dna.revcomp(m1), m2, dna.revcomp(m2)))
        rm = pm.ref.map_fragment_pe(m1, m2, expected)
        mapped[f] = rm.label is not None
        occ[f] = len(rm.label) if rm.label is not None else 0
        if (f + 1) % 500 == 0:
            log(f"  {f + 1}/{args.frags} ({(f + 1) / (time.time() - t0):.0f}"
                " frags/s)")
    res = {"metric": "hit_capacity_envelope", "frags": args.frags,
           "world": f"{index.num_transcripts} txps gene-family",
           "mapped_unbounded": int(mapped.sum()),
           "sec": round(time.time() - t0, 1)}
    for cap in args.caps:
        over = maxint > cap
        at_risk = over & mapped & (occ <= 200)
        res[f"frac_interval_gt_{cap}"] = round(float(over.mean()), 6)
        res[f"dropped_but_reference_keeps_cap{cap}"] = int(at_risk.sum())
        res[f"dropped_but_reference_keeps_cap{cap}_frac"] = round(
            float(at_risk.mean()), 6)
    return res


# ---------------------------------------------------------------- repeat
class RepeatWorld(NamedTuple):
    seqs: list
    element: np.ndarray
    planted: int
    index: QuasiIndex
    b1: FastqBatch    # mate 1, codes padded with 4 to REPEAT_L
    b2: FastqBatch    # mate 2, reverse-complemented


def repeat_world(frags: int) -> RepeatWorld:
    """tools/capacity_envelope.py main_repeat_device's world: one
    generator of seed 5 draws the element, then per transcript its bases,
    a uniform and, under PLANT_P, the element's offset; then the
    fragments (transcript, length N(250, 25) clipped to [110, 600],
    position), mate 1 and the reverse-complemented mate 2.  The k = 31
    index is the port's build."""
    rng = np.random.default_rng(5)
    element = rng.integers(0, 4, ELEMENT_LEN).astype(np.uint8)
    seqs = []
    planted = 0
    for _ in range(REPEAT_TXPS):
        s = rng.integers(0, 4, REPEAT_TXP_LEN).astype(np.uint8)
        if rng.random() < PLANT_P:
            off = int(rng.integers(0, REPEAT_TXP_LEN - ELEMENT_LEN))
            s[off:off + ELEMENT_LEN] = element
            planted += 1
        seqs.append(s)
    index = build_index([f"t{i}" for i in range(REPEAT_TXPS)], seqs, k=31)
    lens = np.array([len(s) for s in seqs])
    offs = np.concatenate([[0], np.cumsum(lens)])
    concat = np.concatenate(seqs)
    rl = REPEAT_READ_LEN
    t = rng.integers(0, REPEAT_TXPS, frags)
    fl = np.clip(rng.normal(250, 25, frags).astype(int), 110, 600)
    p = (rng.random(frags) * (lens[t] - fl + 1)).astype(int)
    start = offs[t] + p
    m1 = concat[start[:, None] + np.arange(rl)]
    m2 = (3 - concat[start[:, None] + (fl[:, None] - rl)
                     + np.arange(rl)][:, ::-1]).astype(np.uint8)
    c1 = np.full((frags, REPEAT_L), 4, np.uint8)
    c2 = np.full((frags, REPEAT_L), 4, np.uint8)
    c1[:, :rl], c2[:, :rl] = m1, m2
    lens_out = np.full(frags, rl, np.int32)
    return RepeatWorld(seqs, element, planted, index,
                       FastqBatch(c1, lens_out), FastqBatch(c2, lens_out))


class CapRun(NamedTuple):
    result: BatchResult
    escalated: int    # fragments the main pass sent to the wide pass
    overflow: np.ndarray   # their indices in the batch
    backend: DeviceMapperBackend


def run_repeat(args):
    """Repeat mode: returns (the JSON line's dict, the world, {cap:
    CapRun})."""
    dev = as_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    t0 = time.time()
    world = repeat_world(args.frags)
    log(f"repeat world: {REPEAT_TXPS} txps, element in {world.planted} "
        f"({time.time() - t0:.1f}s with the index)")
    element_interval = ProbeSizeMapper(world.index, UNBOUNDED).max_interval(
        world.element[:REPEAT_READ_LEN])
    tidx = TorchIndex.from_quasi_index(world.index, dev)
    expected = parse_library_format("IU")
    res = {"metric": "hit_capacity_envelope_repeat", "frags": args.frags,
           "world": f"{REPEAT_TXPS} txps, {ELEMENT_LEN}bp element "
                    f"x{world.planted}"}
    runs = {}
    for cap in args.caps:
        opts = QuantOpts(batch_size=args.frags, hit_capacity=64,
                         hit_capacity_max=cap)
        be = DeviceMapperBackend(world.index, opts, dev, tindex=tidx)
        t0 = time.time()
        tok = be.submit_pe(world.b1, world.b2, expected)
        escalated = int(tok[0]["scalars"][72])
        overflow = np.nonzero(
            tok[0]["overflow"][:args.frags].cpu().numpy())[0]
        runs[cap] = CapRun(be.finish_batch(tok), escalated, overflow, be)
        res[f"mapped_cap{cap}"] = int(runs[cap].result.mapped.sum())
        log(f"cap {cap}: mapped {res[f'mapped_cap{cap}']}/{args.frags}, "
            f"escalated {escalated} ({time.time() - t0:.2f}s)")
    top = max(args.caps)
    for cap in args.caps:
        if cap < top:
            at_risk = runs[top].result.mapped & ~runs[cap].result.mapped
            key = f"dropped_at_{cap}_kept_at_{top}"
            res[key] = int(at_risk.sum())
            res[f"{key}_frac"] = round(float(at_risk.mean()), 6)
    for cap in args.caps:
        res[f"escalated_cap{cap}"] = runs[cap].escalated
    res.update(element_interval=element_interval, device=dev.type, card=card)
    return res, world, runs


# ---------------------------------------------------------------- entry
def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="sailfish_tpu_torch.capacity_envelope",
        description="fragments that the candidate cap drops and the "
                    "reference keeps (tools/capacity_envelope.py)")
    ap.add_argument("--mode", choices=sorted(MODES), default="probe")
    ap.add_argument("--frags", type=int,
                    help="paired fragments (probe 5,000; repeat 2,048)")
    ap.add_argument("--caps",
                    help="comma-separated capacities (probe 64,256,1024: "
                    "intervals wider than each; repeat 256,2048: "
                    "--hitCapacityMax values)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="repeat mode: cuda (default; fails without a "
                    "card) or cpu, where the kernels' plain versions run")
    add_world_flags(ap)
    ap.set_defaults(cache=None)  # so that repeat mode can refuse it
    args = ap.parse_args(argv)
    world = dict(WORLD_FLAGS["gencode"], cache=DEFAULT_CACHE)
    if args.mode == "repeat":
        given = sorted(f"--{f.replace('_', '-')}"
                       for f in ("txps", "bases", "index_dir", "cache")
                       if getattr(args, f) is not None)
        if given:
            ap.error(f"--mode repeat takes no {', '.join(given)}: its "
                     "world is fixed and built in memory")
    for k in ("txps", "bases", "index_dir", "cache"):
        if getattr(args, k) is None:
            setattr(args, k, world[k])
    for k, v in MODES[args.mode].items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    args.caps = [int(x) for x in args.caps.split(",")]
    if args.frags < 1 or min(args.caps) < 1:
        ap.error("--frags and every cap must be positive")
    return args


def run(args):
    """One mode: prints its JSON line and returns (the line's dict, the
    repeat world, {cap: CapRun}); the last two are None in probe mode."""
    out = (run_repeat(args) if args.mode == "repeat"
           else (run_probe(args), None, None))
    print(json.dumps(out[0]), flush=True)
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
