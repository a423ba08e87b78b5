"""Traffic kind `map`: a pool of paired fragments mapped and folded into
eq classes, as `quant`'s mapping loop runs it.

Set-up makes the world (cached), loads the port's index (built and
cached on the first run: `sailfish index`), builds the backend with
`map/pipeline.py::make_backend`, makes the pool from the seed and maps
its first batches once.  The window submits the pool's batches in turn
with `submit_pe` and folds each with `finish_batch_fast` one batch late
(`quant.py::run_quant`'s one-deep order); each pass over the pool is
one sample with a fresh accumulator.  The window closes on whole
passes: at the first pass boundary after `--seconds` it folds the last
batch and synchronizes, so `frags_per_s` is the rate of whole samples.

The check judges the window's last pass.  Genes are taken in an order
drawn from the seed, each whose fragments in that pass still fit in the
traffic's `check_fragments`; the reference maps every fragment of the
genes taken, and the pass's eq classes that hold a transcript of those
genes must equal the reference's, label for label and count for count
(fragments of other genes cannot reach them: the genes share no
sequence).  The pass's classes must also add up to the fragments the
device counted as mapped, which covers the genes too large to take.
"""

from __future__ import annotations

import collections
import gc
import os
import time

import numpy as np

from ..harness import log
from ..reference.mapper import load_or_build_table, map_pairs
from ..worlds import expression, load_world, padded, simulate, world_seqs


def quant_opts(run):
    """The port's options: the configuration's `quant` group (an unknown
    key raises) and the traffic's batch; the control turns on the
    port's own lower-fidelity scan (`scan_shrink`, the JAX package's
    compacted XLA scan)."""
    from sailfish_tpu_torch.config import QuantOpts

    q = dict(run.cfg["quant"], batch_size=run.traffic["batch"])
    if run.control:
        q.update(run.traffic["control"])
    return QuantOpts(**q)


def sync(run):
    if run.device.type == "cuda":
        import torch

        torch.cuda.synchronize(run.device)


def setup(run):
    from sailfish_tpu_torch.index.builder import (build_index, load_index,
                                                   save_index)
    from sailfish_tpu_torch.io.fastq import FastqBatch
    from sailfish_tpu_torch.libformat import parse_library_format
    from sailfish_tpu_torch.map.pipeline import make_backend

    cfg, tr, sp = run.cfg, run.traffic, run.spans
    with sp("world"):
        world = load_world(cfg, run.cache)
    idx_dir = os.path.join(run.cache, "index")
    if not os.path.exists(os.path.join(idx_dir, "header.json")):
        with sp("index_build"):
            index = build_index([str(n) for n in world["names"]],
                                world_seqs(world), k=cfg["k"])
            save_index(index, idx_dir)
            del index
    opts = quant_opts(run)
    with sp("index_load"):
        index = load_index(idx_dir)
        backend = make_backend(index, opts, run.device)
        sync(run)
    rl = tr["read_len"]
    with sp("pool"):
        rng = np.random.default_rng(run.seed)
        share = expression(world["lens"], tr["abundance"])
        pool, src = [], []
        for _ in range(tr["batches"]):
            m1, m2, t, _, _ = simulate(
                rng, world["concat"], world["offs"], world["lens"],
                tr["batch"], rl, tr["fragment_length"],
                tr["substitution_rate"], share)
            lens = np.full(tr["batch"], rl, np.int32)
            pool.append((FastqBatch(padded(m1), lens),
                         FastqBatch(padded(m2), lens)))
            src.append(t.astype(np.int32))
    expected = parse_library_format(opts.lib_type)
    with sp("warmup"):
        acc = backend.accumulator()
        for b1, b2 in pool[:tr["warmup_batches"]]:
            backend.finish_batch_fast(backend.submit_pe(b1, b2, expected),
                                      acc)
        sync(run)
    run.state.update(world=world, backend=backend, pool=pool, src=src,
                     expected=expected, opts=opts)


def window(run):
    be, pool, exp = (run.state[k] for k in ("backend", "pool", "expected"))
    sp, nb = run.spans, len(pool)
    passes = []

    def new_pass():
        passes.append({"acc": be.accumulator(), "batches": [], "frags": 0,
                       "mapped": 0, "t0": time.perf_counter()})
        return passes[-1]

    def fold(tok, p, b):
        with sp("fold"):
            bs = be.finish_batch_fast(tok, p["acc"])
        p["batches"].append(b)
        p["frags"] += bs.n
        p["mapped"] += bs.num_mapped

    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    cur, pending, i, submitted = new_pass(), None, 0, 0
    while True:
        b = i % nb
        if b == 0 and i:
            if time.perf_counter() >= deadline:
                break
            cur = new_pass()
        with sp("submit"):
            tok = be.submit_pe(*pool[b], exp)
        submitted += pool[b][0].count
        if pending is not None:
            fold(*pending)
        pending = (tok, cur, b)
        i += 1
    fold(*pending)
    sync(run)
    t1 = time.perf_counter()
    frags = sum(p["frags"] for p in passes)
    run.e2e["frags_per_s"] = frags / (t1 - t0)
    run.attempted, run.failed = submitted, submitted - frags
    ends = [t0] + [b for _, b in run.spans.t["fold"]]
    ends[-1] = t1
    run.counters["batch_ms"] = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    run.state["passes"] = passes
    starts = [p["t0"] for p in passes] + [t1]
    log(f"map: {frags} fragments in {t1 - t0:.3f} s over {len(passes)} "
        f"pass(es) of {nb} batches; {len(passes[-1]['acc'])} classes in "
        "the last; pass seconds "
        + " ".join(f"{b - a:.3f}" for a, b in zip(starts, starts[1:])))


def check(run):
    import torch

    st, cfg, tr = run.state, run.cfg, run.traffic
    judged = st["passes"][-1]
    del st["backend"], st["passes"]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    eq = judged["acc"].finish()
    prog = dict(zip(eq.labels(), eq.counts.tolist()))
    fold_gap = abs(int(eq.counts.sum()) - judged["mapped"])
    world, src, pool = st["world"], st["src"], st["pool"]
    T = len(world["lens"])
    gene_of = world.get("gene_of", np.arange(T, dtype=np.int32))
    n_genes = int(gene_of.max()) + 1
    batches = judged["batches"]
    per_gene = np.bincount(gene_of[np.concatenate([src[b] for b in batches])],
                           minlength=n_genes)
    room = tr["check_fragments"]
    in_g = np.zeros(n_genes, bool)
    for g in np.random.default_rng([run.seed, 7]).permutation(n_genes):
        if 0 < per_gene[g] <= room:
            in_g[g] = True
            room -= per_gene[g]
    n_take = int(in_g.sum())
    rl = tr["read_len"]
    m1, m2 = [], []
    for b in batches:
        rows = np.nonzero(in_g[gene_of[src[b]]])[0]
        m1.append(pool[b][0].codes[rows, :rl])
        m2.append(pool[b][1].codes[rows, :rl])
    m1, m2 = np.concatenate(m1), np.concatenate(m2)
    tdir = os.path.join(run.cache, "reftable")
    with run.spans("ref_table"):
        load_or_build_table(world["concat"], world["offs"], cfg["k"], tdir)
    with run.spans("reference"):
        labels = map_pairs(tdir, cfg["quant"], m1, m2, run.workers)
    ref = collections.Counter(lab for lab in labels if lab is not None)
    txps = set(np.nonzero(in_g[gene_of])[0].tolist())
    got = {lab: c for lab, c in prog.items() if not txps.isdisjoint(lab)}
    differ = len(set(got.items()) ^ set(ref.items()))
    log(f"check: pass of {len(batches)} batches, {n_take} genes, "
        f"{len(m1)} fragments ({sum(ref.values())} mapped by the "
        f"reference), {len(ref)} reference classes, {len(got)} classes of "
        f"the port; {len(prog)} classes in the pass")
    run.checks += [("classes_differ", differ, 0),
                   ("fold_total_gap", fold_gap, 0)]
    run.counters.update(check_fragments=len(m1), check_classes=len(ref))
    if run.traced:
        from ..roofline import scan_bound, scan_work
        from ..reference.mapper import KmerTable

        o = st["opts"]
        b1, b2 = pool[0]
        reads = np.concatenate([b1.codes[:, :rl], b2.codes[:, :rl]])
        with run.spans("scan_work"):
            work = scan_work(KmerTable.load(tdir), reads, o.hit_capacity,
                             o.max_mmps, o.mmp_skip == "jump")
        run.counters["scan_work"] = work
        run.counters["scan_bound_ms"] = scan_bound(
            2 * len(reads), b1.codes.shape[1], work, o.hit_capacity,
            o.max_mmps)
