"""The port's spans and counters (sailfish_tpu_torch/trace.py): totals
always, records only while a torch profiler records, on the profiler's
clock; the map path's sync sites and the EM's sync count on the CPU."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sailfish_tpu_torch import trace
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.eqclass.classes import EqClasses
from sailfish_tpu_torch.index.builder import build_index
from sailfish_tpu_torch.infer.em import run_em
from sailfish_tpu_torch.io.fastq import FastqBatch
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend
from torch_port import one_torch_thread  # noqa: F401  (autouse)

READ = 48

# the host syncs of one paired batch whose classes are all new, by site:
# (spans, waits); the same list the card's sync debug mode reports
BATCH_SYNCS = {
    "sync.compat_flags": (2, 2),    # pair.py se_compat_bits' two scalars
    "sync.slot_order": (1, 1),      # pair.py merge_and_collapse
    "sync.postpass": (3, 3),        # one nonzero per MMP after the first
    "sync.bincount": (2, 4),        # two histograms, two reads each
    "sync.scalars": (1, 1),
    "sync.classes": (1, 1),
    "sync.label_index": (1, 1),
    "sync.labels": (1, 1),
}


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


def test_totals_without_a_profiler(fresh):
    """No profiler: totals and self times add up, counts add, nothing is
    recorded; under a profiler the spans add no event of their own."""
    with trace.span("outer", trace.new_id()) as outer:
        with trace.span("inner") as inner:
            trace.count("n", 2)
        trace.count("n")
    agg = trace.aggregates()
    assert trace.records() == []
    assert agg["counters"] == {"n": 3}
    o, i = agg["spans"]["outer"], agg["spans"]["inner"]
    assert o["count"] == i["count"] == 1
    assert o["seconds"] == pytest.approx(outer.seconds)
    assert o["self_seconds"] == pytest.approx(outer.seconds - inner.seconds)
    assert i["self_seconds"] == i["seconds"] == pytest.approx(inner.seconds)
    since = trace.aggregates()
    with trace.span("inner"):
        trace.count("m")
    assert set(trace.aggregates(since)["spans"]) == {"inner"}
    assert trace.aggregates(since)["counters"] == {"m": 1}
    with _profile() as prof:
        with trace.span("outer"):
            torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::sum" in names and not names & {"outer", "inner"}


def test_records_nest_with_ids_self_times_and_counts(fresh):
    one, two = trace.new_id(), trace.new_id()
    with _profile():
        with trace.span("a", one):
            with trace.span("b"):
                with trace.span("c"):
                    trace.count("k", 5)
                trace.count("k")
            with trace.span("b"):
                pass
        with trace.span("a", two):
            assert trace.current_id() == two
    recs = trace.records()
    assert [r.name for r in recs] == ["a", "b", "c", "b", "a"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0, -1]
    assert [r.ident for r in recs] == [one] * 4 + [two]
    assert [r.counts.get("k", 0) for r in recs] == [6, 6, 5, 0, 0]
    a, b, c, b2 = recs[:4]
    assert a.start <= b.start <= c.start <= c.end <= b.end <= b2.start
    assert b.self_ns == b.ns - c.ns
    assert a.self_ns == a.ns - b.ns - b2.ns
    assert trace.current_id() == 0


def test_records_on_the_profilers_clock(fresh):
    """A CPU op run inside a span lies within the span's interval as the
    profiler converts it, to 50 us, in the profiler's own events."""
    x = torch.ones(300, 300)
    with _profile() as prof:
        for _ in range(3):
            with trace.span("mm"):
                torch.mm(x, x)
    spans = [(trace.profiler_ns(r.start), trace.profiler_ns(r.end))
             for r in trace.records()]
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm")
    assert len(ops) == len(spans) == 3
    for (a, b), (s, t) in zip(spans, ops):
        assert a - 50_000 <= s <= t <= b + 50_000


def _world(seed=3, txps=12, length=400, copies=1):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, length).astype(np.uint8)
            for _ in range(txps)]
    seqs = [s for s in seqs for _ in range(copies)]
    return build_index([f"t{i}" for i in range(len(seqs))], seqs, k=31), seqs


def _batch(seqs, n=64, seed=4):
    rng = np.random.default_rng(seed)
    m1 = np.zeros((n, READ), np.uint8)
    m2 = np.zeros((n, READ), np.uint8)
    for i in range(n):
        s = seqs[rng.integers(len(seqs))]
        p = int(rng.integers(0, len(s) - 200))
        m1[i] = s[p:p + READ]
        m2[i] = 3 - s[p + 200 - READ:p + 200][::-1]
    lens = np.full(n, READ, np.int32)
    return FastqBatch(m1, lens), FastqBatch(m2, lens)


def _by_id(recs):
    out = {}
    for r in recs:
        out.setdefault(r.ident, []).append(r)
    return out


def test_one_batch_passes_the_listed_sync_sites(fresh):
    """One paired batch through the device backend on the CPU: every
    span carries the batch's id, and the sync spans are the sites the
    card's sync debug mode lists, 14 waits: the reads go up through the
    staging ring, which does not wait."""
    idx, seqs = _world()
    be = DeviceMapperBackend(idx, QuantOpts(), "cpu")
    exp = parse_library_format("IU")
    b1, b2 = _batch(seqs)
    with _profile():
        tok = be.submit_pe(b1, b2, exp)
        bs = be.finish_batch_fast(tok, be.accumulator())
    assert bs.num_mapped > 0
    recs = trace.records()
    assert set(_by_id(recs)) == {tok[3]}
    top = [r.name for r in recs if r.parent == -1]
    assert top == ["map.submit", "map.fold"]
    names = [r.name for r in recs]
    for n in ("map.pack", "map.copy", "map.enqueue", "map.pull",
              "map.labels", "map.fold_host"):
        assert n in names, n
    got = {}
    for r in recs:
        if r.name.startswith("sync."):
            s, w = got.get(r.name, (0, 0))
            got[r.name] = (s + 1, w + r.counts["syncs"])
    assert got == BATCH_SYNCS
    assert sum(w for _, w in got.values()) == 14
    assert trace.aggregates()["counters"]["syncs"] == 14
    sub = recs[0]
    assert sub.counts["syncs"] == 10
    enq = next(r for r in recs if r.name == "map.enqueue")
    kids = [r for r in recs if r.parent == recs.index(enq)]
    assert {r.name for r in kids} == {"sync.compat_flags", "sync.slot_order",
                                      "sync.postpass", "sync.bincount"}
    assert enq.self_ns == enq.ns - sum(r.ns for r in kids)


def test_escalation_keeps_the_batch_id(fresh):
    """The wide pass's nested submit and fold carry the batch's id."""
    idx, seqs = _world(txps=4, copies=3)
    be = DeviceMapperBackend(idx, QuantOpts(hit_capacity=2,
                                            hit_capacity_max=16), "cpu")
    b1, b2 = _batch(seqs, n=32)
    with _profile():
        tok = be.submit_pe(b1, b2, parse_library_format("IU"))
        bs = be.finish_batch_fast(tok, be.accumulator())
    assert bs.num_escalated > 0
    recs = trace.records()
    assert set(_by_id(recs)) == {tok[3]}
    esc = next(i for i, r in enumerate(recs) if r.name == "map.escalate")
    assert recs[recs[esc].parent].name == "map.fold"
    inner = [r.name for r in recs if r.parent == esc]
    assert inner[:2] == ["map.submit", "map.fold"]
    assert "sync.overflow" in {r.name for r in recs}


def test_em_counts_its_syncs(fresh):
    """`em.syncs` is the count of the solve's sync sites: five uploads of
    the problem and one of the start, one convergence test an iteration
    from `min_iter` on, and four final pulls."""
    rng = np.random.default_rng(1)
    items = {}
    for _ in range(80):
        lab = tuple(sorted(rng.choice(30, int(rng.choice([1, 2, 3])),
                                      replace=False).tolist()))
        items[lab] = items.get(lab, 0) + int(rng.integers(1, 300))
    eq = EqClasses.from_items(sorted(items.items()))
    eff = rng.uniform(100.0, 2000.0, 30)
    with _profile():
        em = run_em(eq, eff, float(eq.total_count()), 30, device="cpu",
                    min_iter=20)
    assert em.num_iterations > 20
    recs = trace.records()
    assert [r.name for r in recs] == ["em.solve", "em.upload", "em.iterate",
                                      "em.pull"]
    solve = recs[0]
    assert solve.counts == {"em.iterations": em.num_iterations,
                            "em.syncs": 6 + (em.num_iterations - 20 + 1)
                            + 4}
    assert len({r.ident for r in recs}) == 1 and solve.ident > 0
