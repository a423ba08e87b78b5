"""Command-line interface of the torch port:
``python -m sailfish_tpu_torch.cli {index, quant, mergeeq, sf}``.

The flag surface is sailfish_tpu/cli.py's (the parsers below are copies
of its parsers) plus `--device {cuda,cpu}`.  `quant` runs on the first
CUDA card by default and fails, with device.py `as_device`'s message,
when torch sees none; `--device cpu` asks for the CPU, where the kernels'
plain torch versions run.  The device is logged and recorded in
aux/meta_info.json.  `--backend refimpl` maps on the host with the numpy
reference mapper (the correctness oracle) and runs EM on the same
device.  `quant` takes several `-l` libraries, --biasCorrect /
--gcBiasCorrect, --numBootstraps / --numGibbsSamples,
--checkpointInterval / --resumeFromEq, and --numShards N --shardId i
with --mapOnly, whose dumps `mergeeq` adds up, and --numShards N
without --shardId, which starts the N shard processes itself, merges
their dumps and infers once (parallel/launcher.py; it refuses the bias
flags).  32-bit and 64-bit (big_sa) indexes, indexes of any k (k < 17
maps through the prefix table) and sharded indexes (`index
--indexShards D`; every shard on `--device`) are taken.  Refused with a
usage error: --scanShrink above 1 with --kernel pallas or xla2, and on
a sharded index `--backend refimpl` and the bias flags (the JAX
package's messages).  --scanShrink N gives the results of the JAX
package's xla kernel, which its `--kernel auto` runs off a TPU; a
sharded index ignores it, as there.  The TPU path's fast-path tuning
knobs and the kernel choice change no output and are accepted and
ignored.  `sf` prints the logo.  The op-chain
microbenchmark is an entry point of its own: ``python -m
sailfish_tpu_torch.ubench``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from . import __version__
from .config import QuantOpts
from .device import as_device
from .index.builder import (
    build_index_from_fasta,
    save_index,
    save_sharded_index,
)
from .io.fasta import read_fasta
from .io.native import native_sais_available

log = logging.getLogger("sailfish_tpu_torch")


def _setup_logging(output_dir: str | None = None) -> None:
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if output_dir:
        log_dir = os.path.join(output_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(
            logging.FileHandler(os.path.join(log_dir, "sailfish_quant.log"))
        )
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(name)s] %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )


def _add_index_parser(sub):
    p = sub.add_parser("index", help="build a quasi-mapping index")
    p.add_argument("-t", "--transcripts", required=True, help="transcriptome FASTA")
    p.add_argument("-o", "--out", required=True, help="output index directory")
    p.add_argument("-k", "--kmerSize", type=int, default=31,
                   help="k-mer size (odd, <= 31)")
    p.add_argument("--prefixBases", type=int, default=0,
                   help="prefix-table width in bases (0 = auto)")
    p.add_argument("-f", "--force", action="store_true",
                   help="rebuild even if the index exists")
    p.add_argument("--indexShards", type=int, default=0,
                   help="stripe the index into D standalone shards over "
                   "contiguous transcript ranges (prefix table of 10 "
                   "bases unless --prefixBases); quant maps them with "
                   "every shard on --device")
    return p


def _add_quant_parser(sub):
    p = sub.add_parser("quant", help="quantify a sample")
    p.add_argument("-i", "--index", required=True)
    # -l may repeat: each occurrence starts a new read library whose
    # following -1/-2/-r groups attach to it (ordered-argv semantics of
    # the reference extractReadLibraries, src/SailfishUtils.cpp:103-153)
    p.add_argument("-l", "--libType", required=True, action="append")
    p.add_argument("-1", "--mates1", nargs="+", action="append",
                   default=[])
    p.add_argument("-2", "--mates2", nargs="+", action="append",
                   default=[])
    p.add_argument("-r", "--unmatedReads", nargs="+", action="append",
                   default=[])
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-g", "--geneMap", default="")
    p.add_argument("--txpAggregationKey", default="gene_id")
    p.add_argument("--auxDir", default="aux")
    p.add_argument("--dumpEq", action="store_true")
    p.add_argument("--checkpointInterval", type=int, default=0,
                   help="write an eq-class checkpoint (plus FLD/counter "
                   "state) every N processed fragments (0 = off); resume "
                   "with --resumeFromEq")
    p.add_argument("--resumeFromEq", default="",
                   help="resume from an eq_classes.txt checkpoint (file "
                   "or quant output dir): skip mapping, re-run inference")
    p.add_argument("--biasCorrect", action="store_true")
    p.add_argument("--gcBiasCorrect", action="store_true")
    p.add_argument("--gcSizeSamp", type=int, default=1)
    p.add_argument("--gcSpeedSamp", type=int, default=1)
    p.add_argument("--strictIntersect", action="store_true")
    p.add_argument("--unsmoothedFLD", action="store_true")
    p.add_argument("--maxFragLen", type=int, default=1000)
    p.add_argument("--ignoreLibCompat", action="store_true")
    p.add_argument("--enforceLibCompat", action="store_true")
    p.add_argument("--allowDovetail", action="store_true")
    p.add_argument("--discardOrphans", action="store_true")
    p.add_argument("--numBiasSamples", type=int, default=1000000)
    p.add_argument("--numFragSamples", type=int, default=10000)
    p.add_argument("--fldMean", type=int, default=200)
    p.add_argument("--fldSD", type=int, default=80)
    p.add_argument("-w", "--maxReadOcc", type=int, default=200)
    p.add_argument("--noEffectiveLengthCorrection", action="store_true")
    p.add_argument("--useVBOpt", action="store_true")
    p.add_argument("--numGibbsSamples", type=int, default=0)
    p.add_argument("--numBootstraps", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-p", "--numThreads", type=int, default=4,
                   help="host-side IO/decode workers")
    p.add_argument("--numShards", type=int, default=1,
                   help="multi-host data parallelism: total number of "
                   "read shards; without --shardId, run all of them as "
                   "processes on --device, merge and infer once")
    p.add_argument("--shardId", type=int, default=-1,
                   help="this host's shard index in [0, numShards): "
                   "it maps every numShards-th batch; combine the "
                   "--mapOnly dumps with mergeeq")
    p.add_argument("--mapOnly", action="store_true",
                   help="stop after mapping: write the eq-class dump + "
                   "quant state, skip inference and outputs (the "
                   "per-shard half of a multi-host run)")
    # device path
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where mapping and EM run: the first CUDA card "
                   "(default; an error when torch sees none) or the CPU, "
                   "with the kernels' plain torch versions")
    p.add_argument("--backend", choices=["device", "refimpl"],
                   default="device",
                   help="device: map on --device; refimpl: map on the "
                   "host with the numpy reference mapper (the oracle)")
    p.add_argument("--kernel", choices=["auto", "xla", "xla2", "pallas"],
                   default="auto",
                   help="the JAX package's kernel choice; accepted and "
                   "ignored (the port has one scan kernel), but pallas "
                   "and xla2 refuse --scanShrink above 1")
    p.add_argument("--batchSize", type=int, default=65536)
    p.add_argument("--dtype", choices=["float32", "float64"], default="")
    p.add_argument("--hitCapacity", type=int, default=64,
                   help="static per-orientation candidate capacity of the "
                   "device kernels; reads above it are dropped like "
                   "--maxReadOcc (unless --hitCapacityMax escalates them)")
    p.add_argument("--hitCapacityMax", type=int, default=1024,
                   help="escalation capacity: fragments whose candidate "
                   "set overflows --hitCapacity are re-mapped through a "
                   "wide-capacity second pass of the same kernel at this "
                   "capacity (0 = off)")
    p.add_argument("--xla2SweepWin", type=int, default=0,
                   help="accepted and ignored (a tuning knob of the JAX "
                   "package's xla2 kernel; identical results)")
    p.add_argument("--scanShrink", type=int, default=1,
                   help=">1: the JAX package's xla kernel's compacted "
                   "scan: after the first step the scanned lanes shrink "
                   "by this factor a step (64 at least), and the lanes "
                   "left out stop with the MMPs they have. It changes "
                   "results (fewer hits where reads need many steps) "
                   "and is not a speed option here; the same results as "
                   "the JAX package's --kernel xla. A sharded index "
                   "ignores it")
    p.add_argument("--mmpSkip", choices=["jump", "nip"], default="nip",
                   help="MMP advance rule: nip = the RapMap-style overlap "
                   "re-probe (reference parity, default), jump = restart "
                   "past the mismatch (faster, diverges on error-bearing "
                   "reads; see FIDELITY.md)")
    # the TPU path's fast-path tuning flags: every combination gives
    # bit-identical output there, so they are accepted and ignored here
    adv = p.add_argument_group(
        "advanced mapping tuning of the JAX package (accepted and "
        "ignored: bit-identical output)")
    adv.add_argument("--noFastPath", action="store_true",
                     help="disable the clean-lane fast path")
    adv.add_argument("--noXscan", action="store_true",
                     help="disable the vectorized NIP-scan state machine "
                     "(all residual lanes go through the kernel)")
    adv.add_argument("--noLaneScreen", action="store_true",
                     help="disable the 16-mer Bloom lane screen")
    adv.add_argument("--noLaneCompact", action="store_true",
                     help="disable live-lane compaction")
    adv.add_argument("--noPackedLanes", action="store_true",
                     help="build lanes from per-base codes instead of "
                     "the 2-bit packed words")
    adv.add_argument("--xscanT", type=int, default=7,
                     help="xscan full-event budget per lane")
    adv.add_argument("--xscanF", type=int, default=4,
                     help="xscan candidate slots (<= 8)")
    adv.add_argument("--xscanT1", type=int, default=2,
                     help="xscan light phase-A event budget")
    adv.add_argument("--xscanP2", type=int, default=2,
                     help="xscan phase-B compacted-prefix divisor")
    adv.add_argument("--xscanSchedule", default="2:1,4:1,8:3",
                     help="xscan phase-B narrowing schedule "
                     "'div:steps,...'")
    return p


def extract_read_libraries(argv: list[str]) -> list[dict]:
    """Ordered-argv read-library extraction (the reference's
    extractReadLibraries, src/SailfishUtils.cpp:103-153): every
    -l/--libType occurrence starts a new library; subsequent
    -1/-2/-r file groups attach to the most recent one."""
    flagmap = {
        "-l": "fmt", "--libType": "fmt",
        "-1": "m1", "--mates1": "m1",
        "-2": "m2", "--mates2": "m2",
        "-r": "um", "--unmatedReads": "um",
    }
    libs: list[dict] = []
    cur: dict | None = None
    i = 0
    while i < len(argv):
        tok = argv[i]
        inline = None
        if tok.startswith("--") and "=" in tok:
            tok, inline = tok.split("=", 1)
        key = flagmap.get(tok)
        if key == "fmt":
            if inline is None:
                i += 1
                inline = argv[i] if i < len(argv) else ""
            cur = {"fmt": inline, "m1": [], "m2": [], "um": []}
            libs.append(cur)
        elif key is not None:
            if cur is None:
                raise ValueError(
                    f"{tok} appears before any -l/--libType; each read "
                    "library must start with its libType")
            if inline is not None:
                cur[key].append(inline)
            else:
                while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                    i += 1
                    cur[key].append(argv[i])
        i += 1
    return libs


def _flatten_read_args(args, argv):
    """Normalize the append-style -l/-1/-2/-r argparse results: returns
    (lib_type, mates1, mates2, unmated, libraries) where libraries is
    [] for the single-library form (back-compat QuantOpts fields) and
    the ordered per-library list otherwise."""
    libtypes = args.libType if isinstance(args.libType, list) else [args.libType]
    m1 = [f for grp in args.mates1 for f in grp]
    m2 = [f for grp in args.mates2 for f in grp]
    um = [f for grp in args.unmatedReads for f in grp]
    if len(libtypes) <= 1:
        return libtypes[0], m1, m2, um, []
    libs = extract_read_libraries(argv)
    if len(libs) != len(libtypes):
        raise ValueError(
            "could not associate read files with libTypes from the "
            "argument order")
    return libtypes[0], m1, m2, um, libs


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sailfish_tpu_torch",
        description=f"sailfish_tpu_torch v{__version__} — PyTorch/CUDA "
        "port of the sailfish_tpu transcript quantifier")
    parser.add_argument("-v", "--version", action="version",
                        version=f"sailfish_tpu_torch {__version__}")
    parser.add_argument("--no-version-check", action="store_true",
                        help="accepted for CLI parity")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_index_parser(sub)
    _add_quant_parser(sub)
    sub.add_parser("sf", help="print the logo")
    pm = sub.add_parser(
        "mergeeq",
        help="merge eq-class dumps from sharded quant runs into one")
    pm.add_argument("dumps", nargs="+",
                    help="eq_classes.txt files or quant output dirs")
    pm.add_argument("-o", "--output", required=True,
                    help="merged eq_classes.txt path")
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "index":
        return _main_index(parser, args)
    if args.command == "mergeeq":
        return _main_mergeeq(args)
    if args.command == "sf":
        # the reference's easter egg (src/Sailfish.cpp:73-85), as
        # sailfish_tpu/cli.py prints it
        sys.stderr.write(LOGO)
        return 0
    return _main_quant(parser, args, argv)


LOGO = r"""
   _____       _ _______      __      __
  / ___/____ _(_) / __(_)____/ /_    / /_____  __  __
  \__ \/ __ `/ / / /_/ / ___/ __ \  / __/ __ \/ / / /
 ___/ / /_/ / / / __/ (__  ) / / / / /_/ /_/ / /_/ /
/____/\__,_/_/_/_/ /_/____/_/ /_/  \__/ .___/\__,_/
                                     /_/
"""


def _main_mergeeq(args) -> int:
    from .eqclass.io import find_eq_dump, merge_eq_dumps, write_eq_dump

    _setup_logging()
    paths = [find_eq_dump(d) for d in args.dumps]
    names, eq = merge_eq_dumps(paths)
    write_eq_dump(args.output, names, eq)
    log.info("merged %d dumps -> %d classes (%d fragments)", len(paths),
             eq.num_classes, eq.total_count())
    return 0


def _main_index(parser, args) -> int:
    if args.kmerSize % 2 == 0:
        parser.error(f"k-mer size must be odd (got {args.kmerSize})")
    _setup_logging()
    if os.path.exists(os.path.join(args.out, "header.json")) \
            and not args.force:
        log.info("index already exists at %s; use --force to rebuild",
                 args.out)
        return 0
    t0 = time.time()
    if args.indexShards > 1:
        from .parallel.shardidx import sharded_index

        names, seqs = read_fasta(args.transcripts)
        sidx = sharded_index(names, seqs, args.indexShards, k=args.kmerSize,
                             prefix_bases=args.prefixBases or 10)
        save_sharded_index(sidx, args.out)
        log.info("built %d-shard index over %d transcripts (%d bases) in "
                 "%.2fs", args.indexShards, sidx.num_transcripts,
                 sidx.text_len, time.time() - t0)
        return 0
    idx = build_index_from_fasta(args.transcripts, k=args.kmerSize,
                                 prefix_bases=args.prefixBases)
    save_index(idx, args.out)
    log.info("built index over %d transcripts (%d bases) in %.2fs "
             "(suffix array: %s)", idx.num_transcripts, idx.text_len,
             time.time() - t0,
             "native SA-IS" if native_sais_available() else "numpy")
    return 0


def _main_quant(parser, args, argv) -> int:
    from .parallel.launcher import check_launch, run_sharded_quant
    from .map.pipeline import ShardedIndexRefusal
    from .quant import check_slice, run_quant

    try:
        lib_type, m1, m2, um, libraries = _flatten_read_args(args, argv)
    except ValueError as e:
        parser.error(str(e))
    # cmd_info.json echoes flat values
    args.libType = ([lib["fmt"] for lib in libraries] if libraries
                    else lib_type)
    args.mates1, args.mates2, args.unmatedReads = m1, m2, um
    # --numShards N without --shardId: start the shard processes here
    launch = args.numShards > 1 and args.shardId < 0
    try:
        opts = _quant_opts(args, lib_type, m1, m2, um, libraries)
        check_slice(opts, kernel=args.kernel)
        if launch:
            check_launch(opts)
    except (NotImplementedError, ValueError) as e:
        parser.error(str(e))
    _setup_logging(args.output)
    ordered = [("command", "quant")] + [
        (k, v) for k, v in vars(args).items()
        if k not in ("command", "read_libraries_")
    ]
    # the card unless the caller asked for the CPU: without a card
    # as_device raises, it does not fall back
    if launch:
        stats = run_sharded_quant(args, argv, opts, as_device(args.device),
                                  ordered)
    else:
        try:
            stats = run_quant(opts, device=args.device, backend=args.backend,
                              ordered_opts=ordered)
        except ShardedIndexRefusal as e:
            parser.error(str(e))
    log.info("done: %s", json.dumps({
        k: v for k, v in stats.items() if isinstance(v, (int, float, str))
    }))
    return 0


def _quant_opts(args, lib_type, m1, m2, um, libraries) -> QuantOpts:
    return QuantOpts(
        index_dir=args.index, output_dir=args.output, aux_dir=args.auxDir,
        lib_type=lib_type, mates1=m1, mates2=m2, unmated_reads=um,
        libraries=libraries,
        max_read_occs=args.maxReadOcc,
        strict_intersect=args.strictIntersect,
        allow_dovetail=args.allowDovetail,
        allow_orphans=not args.discardOrphans,
        ignore_lib_compat=args.ignoreLibCompat,
        enforce_lib_compat=args.enforceLibCompat,
        max_frag_len=args.maxFragLen, num_frag_samples=args.numFragSamples,
        fld_mean=args.fldMean, fld_sd=args.fldSD,
        use_unsmoothed_fld=args.unsmoothedFLD,
        no_effective_length_correction=args.noEffectiveLengthCorrection,
        bias_correct=args.biasCorrect, gc_bias_correct=args.gcBiasCorrect,
        num_bias_samples=args.numBiasSamples, gc_samp_factor=args.gcSizeSamp,
        pdf_samp_factor=args.gcSpeedSamp,
        use_vb_opt=args.useVBOpt, num_gibbs_samples=args.numGibbsSamples,
        num_bootstraps=args.numBootstraps, dump_eq=args.dumpEq,
        checkpoint_interval=args.checkpointInterval,
        resume_from_eq=args.resumeFromEq, gene_map=args.geneMap,
        txp_aggregation_key=args.txpAggregationKey,
        batch_size=args.batchSize, num_threads=args.numThreads,
        num_shards=args.numShards, shard_id=max(args.shardId, 0),
        map_only=args.mapOnly, seed=args.seed,
        dtype=args.dtype or "float64", hit_capacity=args.hitCapacity,
        hit_capacity_max=args.hitCapacityMax, scan_shrink=args.scanShrink,
        mmp_skip=args.mmpSkip,
    )


if __name__ == "__main__":
    sys.exit(main())
