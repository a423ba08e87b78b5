"""Traffic kind `em`: the collapsed EM on the eq classes of a fragment
sample, as `quant.py::_infer_and_write` runs it (float64, the
configuration's tolerance and iteration limits).

Set-up makes the world (cached), draws the sample with the map
traffic's laws from the traffic's own `sample_seed`, forms its eq
classes from the exon structure (`eqsample.py`) and its effective
lengths from its own fragment lengths, lists the classes in an order
drawn from the run's seed, and solves once.  Every seed thus solves the
same classes in another order: the iterations to convergence follow the
sample closely (938-1,608 over samples of one profile), which a drawn
sample would turn into the seed's work.  The window repeats
`infer/em.py::run_em` from the uniform start to convergence until
`--seconds` have passed.

The check: the reference EM (`reference/em.py`, float64, deterministic
sums) solves the same classes; the largest gap between the window's last
abundances and the reference's, each over the larger of the reference's
abundance and one fragment, is held to the traffic's limit.  The
control puts the reference in float32 in the program's place.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from ..eqsample import effective_lengths, fragment_classes
from ..harness import log
from ..reference import em as ref_em
from ..worlds import draw_fragments, expression, load_world


def _solve(run):
    import torch

    cl, q = run.state["classes"], run.cfg["quant"]
    if run.control:
        a, it = ref_em.solve(cl["members"], cl["offsets"], cl["counts"],
                             cl["eff"], cl["total"], cl["T"],
                             device=run.device, dtype=torch.float32,
                             tol=q["em_tolerance"],
                             min_iter=run.cfg["em_min_iter"],
                             max_iter=q["em_max_iter"])
        return a, it
    from sailfish_tpu_torch.infer.em import run_em

    em = run_em(run.state["eq"], cl["eff"], cl["total"], cl["T"],
                device=run.device, rel_diff_tol=q["em_tolerance"],
                max_iter=q["em_max_iter"], min_iter=run.cfg["em_min_iter"],
                dtype=getattr(torch, q["dtype"]))
    return em.alphas, em.num_iterations


def setup(run):
    from sailfish_tpu_torch.eqclass.classes import EqClasses

    tr, sp = run.traffic, run.spans
    with sp("world"):
        world = load_world(run.cfg, run.cache)
    with sp("classes"):
        rng = np.random.default_rng(tr["sample_seed"])
        t, p, fl = draw_fragments(rng, world["lens"], tr["fragments"],
                                  tr["fragment_length"],
                                  expression(world["lens"], tr["abundance"]))
        labels, counts = fragment_classes(world, t, p, fl)
        order = np.random.default_rng(run.seed).permutation(len(labels))
        labels, counts = [labels[i] for i in order], counts[order]
        sizes = np.array([len(lab) for lab in labels], np.int64)
        offsets = np.zeros(len(labels) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        members = np.fromiter((x for lab in labels for x in lab), np.int32,
                              int(offsets[-1]))
        eff = effective_lengths(world["lens"], fl)
    run.state["classes"] = dict(members=members, offsets=offsets,
                                counts=counts, eff=eff,
                                total=float(tr["fragments"]),
                                T=len(world["lens"]))
    run.state["eq"] = EqClasses(members=members, offsets=offsets,
                                counts=counts)
    with sp("warmup"):
        _solve(run)
    log(f"em: {len(labels)} classes, {len(members)} members, "
        f"{tr['fragments']} fragments")


def window(run):
    t0 = time.perf_counter()
    iters = []
    while True:
        with run.spans("solve"):
            alphas, it = _solve(run)
        iters.append(int(it))
        if time.perf_counter() - t0 >= run.seconds:
            break
    dt = time.perf_counter() - t0
    run.e2e["em_solve_s"] = dt / len(iters)
    run.attempted = len(iters)
    run.failed = sum(1 for it in iters
                     if it >= run.cfg["quant"]["em_max_iter"])
    run.counters.update(em_iters=iters, em_window_s=dt)
    run.state["alphas"] = alphas
    log(f"em: {len(iters)} solves in {dt:.3f} s, iterations "
        f"{min(iters)}-{max(iters)}")


def check(run):
    import torch

    cl, q = run.state["classes"], run.cfg["quant"]
    alphas = run.state.pop("alphas")
    del run.state["eq"]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    with run.spans("reference"):
        ref, it = ref_em.solve(cl["members"], cl["offsets"], cl["counts"],
                               cl["eff"], cl["total"], cl["T"],
                               device=run.device, dtype=torch.float64,
                               tol=q["em_tolerance"],
                               min_iter=run.cfg["em_min_iter"],
                               max_iter=q["em_max_iter"])
    gap = float(np.max(np.abs(alphas - ref) / np.maximum(ref, 1.0)))
    log(f"check: reference {it} iterations, the window's last "
        f"{run.counters['em_iters'][-1]}")
    run.counters["ref_iters"] = it
    run.checks.append(("alpha_gap", gap, run.traffic["limits"]["alpha_gap"]))
