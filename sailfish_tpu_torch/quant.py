"""Quantification pipeline of the torch port: one read library per run,
paired-end or single-end, of any of the library types of libformat.py.

Counterpart of sailfish_tpu/quant.py `run_quant` (mapping loop, FLD,
effective lengths, EM, outputs).  It writes the same files.  Options
outside the ported slice raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from .config import QuantOpts
from .device import as_device, describe, synchronize
from .index.builder import load_index
from .infer.em import run_em
from .io.fastq import (
    _iter_fastq_seq_blocks,
    iter_fastq_batches,
    iter_paired_fastq_batches,
)
from .libformat import ReadType, parse_library_format
from .map.pipeline import make_backend
from .output.genemap import generate_gene_level_estimates
from .output.writers import QuantWriter
from .stats.fld import EmpiricalDistribution, effective_lengths_from_fld

log = logging.getLogger("sailfish_tpu_torch")


@dataclasses.dataclass
class ExperimentState:
    num_observed: int = 0
    num_mapped: int = 0
    num_frag_hits: int = 0
    upper_bound_hits: int = 0
    num_fwd: int = 0
    num_rc: int = 0
    remaining_fl_ops: int = 0
    fl_hist: np.ndarray | None = None
    lib_fmt_counts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(64, dtype=np.int64))
    num_compat: int = 0


def check_slice(opts: QuantOpts):
    """Refuse options the port does not implement yet; returns the one
    read library (dict with fmt, m1, m2, um)."""
    unsupported = {
        "bias correction (--biasCorrect / --gcBiasCorrect)":
            opts.bias_correct or opts.gc_bias_correct,
        "Gibbs sampling (--numGibbsSamples)": opts.num_gibbs_samples > 0,
        "bootstrapping (--numBootstraps)": opts.num_bootstraps > 0,
        "resume from an eq-class dump (--resumeFromEq)":
            bool(opts.resume_from_eq),
        "eq-class checkpoints (--checkpointInterval)":
            opts.checkpoint_interval > 0,
        "multi-host sharding (--numShards / --shardId / --mapOnly)":
            opts.num_shards > 1 or opts.shard_id != 0 or opts.map_only,
        "compacted scan steps (--scanShrink)": opts.scan_shrink != 1,
    }
    for what, on in unsupported.items():
        if on:
            raise NotImplementedError(
                f"{what} is not supported by the torch port yet")
    libs = opts.read_libraries()
    if len(libs) != 1:
        raise NotImplementedError(
            "the torch port quantifies one read library per run so far")
    lib = libs[0]
    if parse_library_format(lib["fmt"]).type == ReadType.PAIRED_END:
        if not lib["m1"] or not lib["m2"]:
            raise ValueError("paired-end libType requires --mates1/--mates2")
        if len(lib["m1"]) != len(lib["m2"]):
            raise ValueError(
                "--mates1 and --mates2 must list the same number of files")
    elif not lib["um"]:
        raise ValueError("single-end libType requires --unmatedReads")
    return lib


def probe_max_len(path: str, probe_reads: int = 1024) -> int:
    """Batch width from the first reads, rounded up to a multiple of 8
    (the FASTQ reader re-pads if a longer read appears later)."""
    m = 0
    for block in _iter_fastq_seq_blocks(path, probe_reads):
        m = max(m, max(len(s) for s in block))
        break
    return max(8, (m + 7) // 8 * 8)


def _accumulate(bs, state: ExperimentState, max_frag_len: int) -> None:
    """Fold one batch's counters; the FLD takes the first
    numFragSamples unique-paired fragments in file order."""
    state.num_observed += bs.n
    state.num_frag_hits += bs.sum_joint
    state.upper_bound_hits += bs.ub_hits
    state.num_mapped += bs.num_mapped
    state.num_fwd += bs.num_fwd
    state.num_rc += bs.num_rc
    state.lib_fmt_counts += bs.fmt_counts
    state.num_compat += bs.num_compat
    if state.remaining_fl_ops > 0 and bs.fld_count:
        if bs.fld_count <= state.remaining_fl_ops:
            state.fl_hist += bs.fld_hist()
            state.remaining_fl_ops -= bs.fld_count
        else:
            fls, up = bs.fld_details()
            fls = fls[up]
            fls = fls[fls < max_frag_len][:state.remaining_fl_ops]
            if len(fls):
                state.fl_hist += np.bincount(fls, minlength=max_frag_len)
                state.remaining_fl_ops -= len(fls)


def _write_quant_state(aux_path: str, state: ExperimentState) -> None:
    """Counters + FLD histogram beside the eq dump (the JAX package's
    aux/quant_state.json)."""
    doc = {
        "num_observed": int(state.num_observed),
        "num_mapped": int(state.num_mapped),
        "num_frag_hits": int(state.num_frag_hits),
        "upper_bound_hits": int(state.upper_bound_hits),
        "num_fwd": int(state.num_fwd),
        "num_rc": int(state.num_rc),
        "remaining_fl_ops": int(state.remaining_fl_ops),
        "fl_hist": [int(x) for x in state.fl_hist],
        "lib_fmt_counts": [int(x) for x in state.lib_fmt_counts],
        "num_compat": int(state.num_compat),
    }
    tmp = os.path.join(aux_path, "quant_state.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, os.path.join(aux_path, "quant_state.json"))


def run_quant(opts: QuantOpts, *, device, backend: str = "device",
              ordered_opts: list | None = None) -> dict:
    """Map every fragment of the read library on `device` (or on the
    host with backend "refimpl"), infer abundances on `device` and
    write quant.sf plus the aux outputs.  Returns run statistics
    (counts, EM iterations, per-batch wall-clock ms)."""
    t_start = time.time()
    start_time = time.strftime("%a %b %d %H:%M:%S %Y")
    lib = check_slice(opts)
    expected = parse_library_format(lib["fmt"])
    paired = expected.type == ReadType.PAIRED_END
    dev = as_device(device)
    log.info("torch port on %s (%s backend)", describe(dev), backend)

    t0 = time.time()
    index = load_index(opts.index_dir)
    t_index = time.time() - t0
    names = index.names
    ref_lens = index.txp_lens.astype(np.int64)
    num_txps = len(names)

    writer = QuantWriter(opts.output_dir, opts.aux_dir)
    writer.write_cmd_info(ordered_opts or [])
    state = ExperimentState(
        remaining_fl_ops=opts.num_frag_samples,
        fl_hist=np.zeros(opts.max_frag_len, dtype=np.int64))
    mapper = make_backend(index, opts, dev, backend)
    acc = mapper.accumulator()

    # one-deep pipeline: batch n+1's upload and mapping are queued on the
    # device before the host folds batch n
    batch_ms: list[float] = []
    num_escalated = 0
    t_map0 = time.time()
    t_last = t_map0
    pending = None

    def fold(token):
        nonlocal t_last, num_escalated
        bs = mapper.finish_batch_fast(token, acc)
        _accumulate(bs, state, opts.max_frag_len)
        num_escalated += bs.num_escalated
        now = time.time()
        batch_ms.append(1e3 * (now - t_last))
        t_last = now

    def tokens():
        if paired:
            for f1, f2 in zip(lib["m1"], lib["m2"]):
                ml = max(probe_max_len(f1), probe_max_len(f2))
                for b1, b2 in iter_paired_fastq_batches(
                        f1, f2, opts.batch_size, max_len=ml,
                        decode_threads=opts.num_threads):
                    yield mapper.submit_pe(b1, b2, expected)
        else:
            for f in lib["um"]:
                for b in iter_fastq_batches(f, opts.batch_size,
                                            max_len=probe_max_len(f)):
                    yield mapper.submit_se(b, expected)

    for token in tokens():
        if pending is not None:
            fold(pending)
        pending = token
    if pending is not None:
        fold(pending)
    synchronize(dev)
    t_map = time.time() - t_map0
    log.info("mapped %d/%d fragments (%.2f%%) in %.2fs (%.0f reads/s); "
             "%d escalated", state.num_mapped, state.num_observed,
             100.0 * state.num_mapped / max(1, state.num_observed), t_map,
             state.num_observed / max(t_map, 1e-9), num_escalated)

    eq = acc.finish()
    log.info("computed %d rich equivalence classes", eq.num_classes)
    num_fld_obs = opts.num_frag_samples - state.remaining_fl_ops
    if opts.no_effective_length_correction:
        eff_lens = ref_lens.astype(np.float64)
        fld_hist = state.fl_hist.astype(np.int32)
    else:
        eff_lens, fld_hist = effective_lengths_from_fld(
            ref_lens, state.fl_hist, num_observed=num_fld_obs,
            num_required=opts.num_frag_samples, fld_mean=opts.fld_mean,
            fld_sd=opts.fld_sd, max_frag_len=opts.max_frag_len,
            use_unsmoothed=opts.use_unsmoothed_fld, paired_end=paired)
    if opts.dump_eq:
        writer.write_equiv_counts(names, eq)
        _write_quant_state(writer.aux_path, state)

    t_em0 = time.time()
    em = run_em(eq, eff_lens, total_mapped=float(state.num_mapped),
                num_txps=num_txps, device=dev, use_vbem=opts.use_vb_opt,
                rel_diff_tol=opts.em_tolerance, max_iter=opts.em_max_iter,
                dtype=getattr(torch, opts.dtype))
    t_em = time.time() - t_em0
    log.info("EM finished: %d iterations in %.2fs (max rel diff %.4g)",
             em.num_iterations, t_em, em.max_rel_diff)

    writer.write_abundances(
        names, ref_lens, eff_lens, em.alphas, float(state.num_mapped),
        no_eff_length_correction=opts.no_effective_length_correction)
    writer.write_lib_format_counts(
        expected.name, state.lib_fmt_counts, state.num_compat,
        state.num_mapped, state.num_observed)
    if state.num_mapped and not opts.ignore_lib_compat:
        frac = state.num_compat / state.num_mapped
        if frac < 0.95:
            log.warning(
                "only %.1f%% of mapped fragments were consistent with the "
                "expected library type (%s); see lib_format_counts.json",
                100.0 * frac, expected.name)
    rng = np.random.default_rng(opts.seed)
    emp = EmpiricalDistribution(np.arange(len(fld_hist), dtype=np.int64),
                                fld_hist.astype(np.int64))
    timings = {
        "index_load_seconds": round(t_index, 3),
        "mapping_seconds": round(t_map, 3),
        "inference_seconds": round(t_em, 3),
        "reads_per_sec": round(state.num_observed / max(t_map, 1e-9), 1),
        "device": describe(dev),
        "backend": backend,
        "batch_ms": [round(x, 3) for x in batch_ms],
        "escalated_fragments": int(num_escalated),
        "em_iterations": int(em.num_iterations),
    }
    writer.write_meta(
        names=names, fld_hist=fld_hist, num_processed=state.num_observed,
        num_mapped=state.num_mapped, num_bootstraps=0, num_gibbs_samples=0,
        bias_correct=False, start_time=start_time,
        fld_realized=emp.realize(rng), timings=timings)
    writer.close()
    if opts.gene_map:
        generate_gene_level_estimates(opts.gene_map, opts.output_dir,
                                      opts.txp_aggregation_key)
    return {
        "num_observed": state.num_observed,
        "num_mapped": state.num_mapped,
        "mapping_rate": state.num_mapped / max(1, state.num_observed),
        "num_eq_classes": eq.num_classes,
        "num_escalated": num_escalated,
        "em_iterations": em.num_iterations,
        "eff_lens": eff_lens,
        "alphas": em.alphas,
        "eq": eq,
        "names": names,
        "batch_ms": batch_ms,
        "map_seconds": t_map,
        "em_seconds": t_em,
        "total_seconds": time.time() - t_start,
    }
