"""Quantification pipeline of the torch port: one or more read
libraries per run, paired-end or single-end, of any of the library types
of libformat.py.

Counterpart of sailfish_tpu/quant.py: `run_quant` is the mapping loop
(all libraries feed one eq-class, FLD and bias state; --checkpointInterval
dumps them as it goes; --numShards/--shardId maps every N-th batch;
--mapOnly stops after the dump) and `_infer_and_write` the tail that
--resumeFromEq enters directly: FLD, effective lengths, EM (with the
bias model's effective-length updates when a bias flag is set), the
output files, then bootstrap or Gibbs samples.  It writes the same
files.  Options outside the ported slice raise NotImplementedError
(`check_slice`).
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
from .eqclass.io import find_eq_dump, read_eq_classes, write_eq_dump
from .index.builder import load_index
from .infer.bootstrap import run_bootstraps
from .infer.em import run_em
from .infer.gibbs import run_gibbs
from .io.fastq import (
    _iter_fastq_seq_blocks,
    iter_fastq_batches,
    iter_paired_fastq_batches,
)
from .libformat import ReadType, parse_library_format
from .map.pipeline import make_backend
from .output.genemap import generate_gene_level_estimates
from .output.writers import QuantWriter
from .stats.bias import BiasState, make_bias_text, run_em_with_bias
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


def check_slice(opts: QuantOpts) -> list:
    """Refuse what the port does not implement yet (NotImplementedError)
    and the combinations the JAX package refuses (ValueError, its
    messages); returns the ordered read libraries."""
    if opts.scan_shrink != 1:
        raise NotImplementedError(
            "compacted scan steps (--scanShrink) are not supported by the "
            "torch port")
    libs = opts.read_libraries()
    if not opts.resume_from_eq:
        for lib in libs:
            if parse_library_format(lib["fmt"]).type == ReadType.PAIRED_END:
                if not lib["m1"] or not lib["m2"]:
                    raise ValueError(
                        "paired-end libType requires --mates1/--mates2")
                if len(lib["m1"]) != len(lib["m2"]):
                    raise ValueError(
                        "--mates1 and --mates2 must list the same number "
                        "of files per library")
            elif not lib["um"]:
                raise ValueError(
                    "single-end libType requires --unmatedReads")
    if not (0 <= opts.shard_id < opts.num_shards):
        raise ValueError(
            f"shard_id {opts.shard_id} out of range for "
            f"{opts.num_shards} shards")
    if opts.num_gibbs_samples > 0 and opts.num_bootstraps > 0:
        raise ValueError(
            "cannot perform both Gibbs sampling and bootstrapping; choose one")
    if opts.bias_correct and opts.gc_bias_correct:
        raise ValueError(
            "enabling both sequence-specific and fragment GC bias correction "
            "simultaneously is not supported")
    return libs


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


def _restore_quant_state(path: str, state: ExperimentState,
                         max_frag_len: int) -> None:
    with open(path) as fh:
        doc = json.load(fh)
    state.num_observed = int(doc["num_observed"])
    state.num_mapped = int(doc["num_mapped"])
    state.num_frag_hits = int(doc["num_frag_hits"])
    state.upper_bound_hits = int(doc["upper_bound_hits"])
    state.num_fwd = int(doc.get("num_fwd", 0))
    state.num_rc = int(doc.get("num_rc", 0))
    state.remaining_fl_ops = int(doc["remaining_fl_ops"])
    fc = np.asarray(doc.get("lib_fmt_counts", np.zeros(64)), dtype=np.int64)
    state.lib_fmt_counts = np.zeros(64, dtype=np.int64)
    state.lib_fmt_counts[:min(len(fc), 64)] = fc[:64]
    state.num_compat = int(doc.get("num_compat", 0))
    hist = np.asarray(doc["fl_hist"], dtype=np.int64)
    fl = np.zeros(max_frag_len, dtype=np.int64)
    n = min(len(hist), max_frag_len)
    fl[:n] = hist[:n]
    state.fl_hist = fl


def _write_checkpoint(aux_path: str, names, eq, state) -> None:
    """eq_classes.txt and quant_state.json, each replaced atomically:
    what --resumeFromEq reads."""
    os.makedirs(aux_path, exist_ok=True)
    write_eq_dump(os.path.join(aux_path, "eq_classes.txt"), names, eq,
                  atomic=True)
    _write_quant_state(aux_path, state)


@dataclasses.dataclass
class _Run:
    """What the mapping loop hands to `_infer_and_write`."""
    opts: QuantOpts
    dev: torch.device
    backend: str
    index: object
    writer: QuantWriter
    state: ExperimentState
    start_time: str
    t_start: float
    t_index: float
    t_map: float = 0.0
    num_escalated: int = 0
    batch_ms: list = dataclasses.field(default_factory=list)
    bias_state: BiasState | None = None
    bias_text: dict | None = None


def run_quant(opts: QuantOpts, *, device, backend: str = "device",
              ordered_opts: list | None = None) -> dict:
    """Map every fragment of the read libraries on `device` (or on the
    host with backend "refimpl"), infer abundances on `device` and
    write quant.sf plus the aux outputs.  Returns run statistics
    (counts, EM iterations, per-batch wall-clock ms)."""
    t_start = time.time()
    start_time = time.strftime("%a %b %d %H:%M:%S %Y")
    libs = check_slice(opts)
    lib_fmts = [parse_library_format(lib["fmt"]) for lib in libs]
    paired_flags = [f.type == ReadType.PAIRED_END for f in lib_fmts]
    if opts.gc_bias_correct and not all(paired_flags):
        log.warning("fragment GC bias correction requires paired-end input; "
                    "disabling")
        opts = dataclasses.replace(opts, gc_bias_correct=False)
    dev = as_device(device)
    log.info("torch port on %s (%s backend)", describe(dev), backend)

    t0 = time.time()
    index = load_index(opts.index_dir)
    t_index = time.time() - t0
    names = index.names

    writer = QuantWriter(opts.output_dir, opts.aux_dir)
    writer.write_cmd_info(ordered_opts or [])
    state = ExperimentState(
        remaining_fl_ops=opts.num_frag_samples,
        fl_hist=np.zeros(opts.max_frag_len, dtype=np.int64))
    run = _Run(opts=opts, dev=dev, backend=backend, index=index,
               writer=writer, state=state, start_time=start_time,
               t_start=t_start, t_index=t_index)

    if opts.resume_from_eq:
        # inference and outputs from an eq-class dump, nothing is mapped
        dump = find_eq_dump(opts.resume_from_eq, opts.aux_dir)
        log.info("resuming from eq-class checkpoint %s", dump)
        dump_names, eq = read_eq_classes(dump)
        if dump_names != names:
            raise ValueError(
                "eq-class dump transcript names do not match the index")
        state_path = os.path.join(os.path.dirname(dump), "quant_state.json")
        if os.path.isfile(state_path):
            # full checkpoint: counters and FLD histogram survive
            _restore_quant_state(state_path, state, opts.max_frag_len)
            log.info("restored quant state (%d fragments, %d FLD "
                     "observations)", state.num_observed,
                     opts.num_frag_samples - state.remaining_fl_ops)
        else:
            # bare dump (mergeeq output): counts only, prior FLD
            total = eq.total_count()
            state.num_observed = state.num_mapped = total
            state.num_frag_hits = state.upper_bound_hits = total
        return _infer_and_write(run, eq)

    mapper = make_backend(index, opts, dev, backend)
    acc = mapper.accumulator()
    if opts.bias_correct or opts.gc_bias_correct:
        run.bias_state = BiasState(opts)
        run.bias_text = getattr(mapper, "bias_text", None)
    aux_path = writer.aux_path
    next_ckpt = opts.checkpoint_interval or None

    # one-deep pipeline: batch n+1's upload and mapping are queued on the
    # device before the host folds batch n
    t_map0 = time.time()
    t_last = t_map0
    pending = None

    def fold(token, b1):
        nonlocal t_last, next_ckpt
        bs = mapper.finish_batch_fast(token, acc)
        _accumulate(bs, state, opts.max_frag_len)
        run.num_escalated += bs.num_escalated
        if run.bias_state is not None:
            run.bias_state.observe_batch(index, b1, bs)
        if next_ckpt is not None and state.num_observed >= next_ckpt:
            next_ckpt = state.num_observed + opts.checkpoint_interval
            _write_checkpoint(aux_path, names, acc.finish(), state)
            log.info("checkpoint: %d fragments, %d eq classes",
                     state.num_observed, len(acc))
        now = time.time()
        run.batch_ms.append(1e3 * (now - t_last))
        t_last = now

    # round-robin batches over shards, skipped inside the decoder; each
    # shard dumps its eq classes and `mergeeq` adds them up
    shard = (opts.shard_id, opts.num_shards)

    def tokens():
        for lib, expected, paired in zip(libs, lib_fmts, paired_flags):
            if paired:
                for f1, f2 in zip(lib["m1"], lib["m2"]):
                    ml = max(probe_max_len(f1), probe_max_len(f2))
                    for b1, b2 in iter_paired_fastq_batches(
                            f1, f2, opts.batch_size, max_len=ml, shard=shard,
                            decode_threads=opts.num_threads):
                        yield mapper.submit_pe(b1, b2, expected), b1
            else:
                for f in lib["um"]:
                    for b in iter_fastq_batches(
                            f, opts.batch_size, max_len=probe_max_len(f),
                            shard=shard):
                        yield mapper.submit_se(b, expected), b

    for nxt in tokens():
        if pending is not None:
            fold(*pending)
        pending = nxt
    if pending is not None:
        fold(*pending)
    synchronize(dev)
    run.t_map = time.time() - t_map0
    log.info("mapped %d/%d fragments (%.2f%%) in %.2fs (%.0f reads/s); "
             "%d escalated", state.num_mapped, state.num_observed,
             100.0 * state.num_mapped / max(1, state.num_observed),
             run.t_map, state.num_observed / max(run.t_map, 1e-9),
             run.num_escalated)

    eq = acc.finish()
    log.info("computed %d rich equivalence classes", eq.num_classes)
    if opts.map_only:
        # the per-shard half of a sharded run: the dump and the state,
        # no inference
        _write_checkpoint(aux_path, names, eq, state)
        log.info("mapOnly: wrote %d eq classes + state for %d fragments",
                 eq.num_classes, state.num_observed)
        return {
            "num_observed": state.num_observed,
            "num_mapped": state.num_mapped,
            "mapping_rate": state.num_mapped / max(1, state.num_observed),
            "num_eq_classes": eq.num_classes,
            "num_escalated": run.num_escalated,
            "em_iterations": 0,
            "batch_ms": run.batch_ms,
            "map_seconds": run.t_map,
            "total_seconds": time.time() - t_start,
        }
    return _infer_and_write(run, eq, paired=any(paired_flags))


def _infer_and_write(run: _Run, eq, *, paired: bool = True) -> dict:
    """Inference and outputs, from the eq classes and counters of a
    mapping loop or of a checkpoint."""
    opts, dev, state, writer = run.opts, run.dev, run.state, run.writer
    names = run.index.names
    ref_lens = run.index.txp_lens.astype(np.int64)
    num_txps = len(names)
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
        # with its sibling state file a --resumeFromEq of this dump
        # recovers the real FLD and counters, not the prior
        _write_checkpoint(writer.aux_path, names, eq, state)

    t_em0 = time.time()
    bias = run.bias_state
    bias_timings = {}
    if bias is not None and eq.num_classes > 0:
        text = run.bias_text
        if text is None:  # the refimpl backend keeps no text on the device
            text = make_bias_text(run.index, dev, opts)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        em, eff_lens, update_s = run_em_with_bias(
            eq, eff_lens, text, bias, state, opts, device=dev)
        bias_timings = {
            "bias_update_seconds": [round(x, 3) for x in update_s],
            "bias_update_peak_bytes": (
                int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else None),
            "bias_samples": int(opts.num_bias_samples
                                - bias.remaining_bias_samples),
            "bias_gc_slots": int(bias.gc_slots),
        }
    else:
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
    expected_name = ";".join(parse_library_format(lib["fmt"]).name
                             for lib in opts.read_libraries())
    writer.write_lib_format_counts(
        expected_name, state.lib_fmt_counts, state.num_compat,
        state.num_mapped, state.num_observed)
    if state.num_mapped and not opts.ignore_lib_compat:
        frac = state.num_compat / state.num_mapped
        if frac < 0.95:
            log.warning(
                "only %.1f%% of mapped fragments were consistent with the "
                "expected library type (%s); see lib_format_counts.json",
                100.0 * frac, expected_name)
    rng = np.random.default_rng(opts.seed)
    emp = EmpiricalDistribution(np.arange(len(fld_hist), dtype=np.int64),
                                fld_hist.astype(np.int64))
    timings = {
        "index_load_seconds": round(run.t_index, 3),
        "mapping_seconds": round(run.t_map, 3),
        "inference_seconds": round(t_em, 3),
        "reads_per_sec": round(state.num_observed / run.t_map, 1)
        if run.t_map else 0.0,
        "device": describe(dev),
        "backend": run.backend,
        "batch_ms": [round(x, 3) for x in run.batch_ms],
        "escalated_fragments": int(run.num_escalated),
        "em_iterations": int(em.num_iterations),
        **bias_timings,
    }
    writer.write_meta(
        names=names, fld_hist=fld_hist, num_processed=state.num_observed,
        num_mapped=state.num_mapped, num_bootstraps=opts.num_bootstraps,
        num_gibbs_samples=opts.num_gibbs_samples,
        bias_correct=opts.bias_correct, start_time=run.start_time,
        fld_realized=emp.realize(rng),
        observed_seq_bias=bias.read_bias_counts if bias else None,
        expected_seq_bias=bias.expected_seq_bias if bias else None,
        observed_gc=bias.observed_gc if bias else None,
        expected_gc=bias.expected_gc if bias else None,
        timings=timings)

    t_samp0 = time.time()
    if opts.num_gibbs_samples > 0 and eq.num_classes > 0:
        log.info("starting Gibbs sampler (%d samples)",
                 opts.num_gibbs_samples)
        for sample in run_gibbs(
                eq, eff_lens, em.alphas, num_txps, device=dev,
                num_samples=opts.num_gibbs_samples,
                total_mapped=float(state.num_mapped), seed=opts.seed):
            writer.write_bootstrap(np.asarray(sample, dtype=np.int32))
        log.info("finished Gibbs sampler")
    elif opts.num_bootstraps > 0 and eq.num_classes > 0:
        log.info("gathering %d bootstrap samples", opts.num_bootstraps)
        for alphas in run_bootstraps(
                eq, eff_lens, num_txps, device=dev,
                num_bootstraps=opts.num_bootstraps,
                use_vbem=opts.use_vb_opt, rel_diff_tol=opts.em_tolerance,
                max_iter=opts.em_max_iter, seed=opts.seed,
                dtype=getattr(torch, opts.dtype)):
            writer.write_bootstrap(np.asarray(alphas, dtype=np.float64))
        log.info("finished bootstraps")
    synchronize(dev)
    t_samp = time.time() - t_samp0
    writer.close()
    if opts.gene_map:
        generate_gene_level_estimates(opts.gene_map, opts.output_dir,
                                      opts.txp_aggregation_key)
    return {
        "num_observed": state.num_observed,
        "num_mapped": state.num_mapped,
        "mapping_rate": state.num_mapped / max(1, state.num_observed),
        "num_eq_classes": eq.num_classes,
        "num_escalated": run.num_escalated,
        "em_iterations": em.num_iterations,
        "eff_lens": eff_lens,
        "alphas": em.alphas,
        "eq": eq,
        "names": names,
        "batch_ms": run.batch_ms,
        "map_seconds": run.t_map,
        "em_seconds": t_em,
        "sampler_seconds": t_samp,
        "total_seconds": time.time() - run.t_start,
    }
