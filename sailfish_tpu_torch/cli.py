"""Command-line interface of the torch port:
``python -m sailfish_tpu_torch.cli {index, quant}``.

The flag surface is sailfish_tpu/cli.py's (the parsers are shared).  The
port runs on the first CUDA device when torch sees one, else on the CPU
with the kernels' plain versions; the device is logged and recorded in
aux/meta_info.json.  `--backend refimpl` maps on the host with the numpy
reference mapper (the correctness oracle) and runs EM on the same
device.  Flags outside the ported slice are refused with an error: bias
correction, Gibbs sampling, bootstrapping, single-end or multiple
libraries, sharded indexes and multi-host runs, checkpoints and resume.
The TPU path's fast-path tuning knobs and the kernel choice change no
output and are accepted and ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import torch

from . import __version__
from .host import (
    QuantOpts,
    _add_index_parser,
    _add_quant_parser,
    _flatten_read_args,
    _setup_logging,
    build_index_from_fasta,
    native_sais_available,
    save_index,
)

log = logging.getLogger("sailfish_tpu_torch")


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
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = _parser()
    args = parser.parse_args(argv)
    if args.command == "index":
        return _main_index(parser, args)
    return _main_quant(parser, args, argv)


def _main_index(parser, args) -> int:
    if args.indexShards > 1:
        parser.error("--indexShards is not supported by the torch port yet")
    if args.kmerSize % 2 == 0:
        parser.error(f"k-mer size must be odd (got {args.kmerSize})")
    _setup_logging()
    if os.path.exists(os.path.join(args.out, "header.json")) \
            and not args.force:
        log.info("index already exists at %s; use --force to rebuild",
                 args.out)
        return 0
    t0 = time.time()
    idx = build_index_from_fasta(args.transcripts, k=args.kmerSize,
                                 prefix_bases=args.prefixBases)
    save_index(idx, args.out)
    log.info("built index over %d transcripts (%d bases) in %.2fs "
             "(suffix array: %s)", idx.num_transcripts, idx.text_len,
             time.time() - t0,
             "native SA-IS" if native_sais_available() else "numpy")
    return 0


def _main_quant(parser, args, argv) -> int:
    from .quant import check_slice, run_quant

    lib_type, m1, m2, um, libraries = _flatten_read_args(args, argv)
    args.libType, args.mates1, args.mates2, args.unmatedReads = (
        lib_type, m1, m2, um)
    opts = QuantOpts(
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
    try:
        check_slice(opts)
    except (NotImplementedError, ValueError) as e:
        parser.error(str(e))
    _setup_logging(args.output)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ordered = [("command", "quant")] + [
        (k, v) for k, v in vars(args).items()
        if k not in ("command", "read_libraries_")
    ]
    stats = run_quant(opts, device=device, backend=args.backend,
                      ordered_opts=ordered)
    log.info("done: %s", json.dumps({
        k: v for k, v in stats.items() if isinstance(v, (int, float, str))
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
