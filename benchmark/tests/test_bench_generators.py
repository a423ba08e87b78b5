"""The benchmark's generators: the read simulator draws what the port's
bench draws under a flat abundance law, the worlds follow their
configurations' laws, and the abundance law is the one stated."""

import json
import os

import numpy as np

from benchmark import eqsample, worlds
from sailfish_tpu_torch import bench

NORMAL = {"law": "normal", "mean": 250, "sd": 25, "lo": 110, "hi": 600}
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def config(name: str, **kw) -> dict:
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return dict(json.load(f), **kw)


def layout(seqs):
    lens = np.array([len(s) for s in seqs], np.int64)
    return np.concatenate(seqs), np.concatenate([[0], np.cumsum(lens)]), lens


def test_flat_reads_equal_the_ports():
    seqs = bench.uniform_seqs(np.random.default_rng(3), 50, 300)
    concat, offs, lens = layout(seqs)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for c1, c2, ln in bench.simulate_uniform(seqs, rb, 2, 300):
        m1, m2, *_ = worlds.simulate(ra, concat, offs, lens, 300, 100,
                                     {"law": "uniform", "lo": 130,
                                      "hi": 320}, 0.005)
        assert np.array_equal(worlds.padded(m1), c1)
        assert np.array_equal(worlds.padded(m2), c2)
        assert (ln == 100).all()
    _, pseqs = bench.build_transcriptome(np.random.default_rng(7), 80, 40_000)
    concat, offs, lens = layout(pseqs)
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(2):
        m1, m2, *_ = worlds.simulate(ra, concat, offs, lens, 500, 100,
                                     NORMAL, 0.005)
        p1, p2 = bench.simulate_batch(rb, concat, offs[:-1], lens, 500)
        assert np.array_equal(m1, p1) and np.array_equal(m2, p2)
        assert np.array_equal(worlds.padded(m1), bench.padded(p1))


def test_gene_structure_world_follows_its_laws():
    cfg = config("gencode", transcripts=3000)
    w = worlds.make_world(cfg)
    law = cfg["world"]
    assert len(w["lens"]) == 3000 and w["lens"].min() >= law["min_len"]
    # the structure spells the transcripts, isoforms of a gene differ
    assert np.array_equal(np.bincount(w["seg_txp"], weights=w["seg_len"]),
                          w["lens"])
    pairs = set(zip(w["gene_of"].tolist(), w["mask_of"].tolist()))
    assert len(pairs) == 3000
    assert np.all(np.diff(w["gene_of"]) >= 0)
    per_gene = np.bincount(w["gene_of"])
    assert per_gene.max() <= law["transcripts_per_gene"]["max"]
    # internal exons: the segments between a transcript's first and last
    ex = w["seg_exon"]
    first = np.r_[True, w["seg_txp"][1:] != w["seg_txp"][:-1]]
    last = np.r_[w["seg_txp"][1:] != w["seg_txp"][:-1], True]
    inner = w["seg_len"][~first & ~last & (ex >= 0)]
    med = law["internal_exon"]["median"]
    assert abs(np.median(inner) - med) < 0.1 * med
    assert ex.max() < law["exons_per_gene"]["max"]


def test_single_exon_world_follows_its_law():
    cfg = config("ecoli")
    w = worlds.make_world(cfg)
    assert len(w["lens"]) == cfg["transcripts"]
    assert abs(w["lens"].mean() - cfg["world"]["length"]["mean"]) < 25
    assert w["lens"].min() >= cfg["world"]["min_len"]


def test_expression_law():
    lens = np.arange(100, 5100, 50)
    law = {"law": "flux", "k": -0.6, "x1": 40, "seed": 3}
    share = worlds.expression(lens, law)
    assert np.isclose(share.sum(), 1.0)
    assert np.array_equal(share, worlds.expression(lens, law))
    rank = np.random.default_rng(3).permutation(len(lens)) + 1.0
    mol = share / lens
    order = np.argsort(rank)
    assert np.all(np.diff(mol[order]) < 0)
    assert np.isclose(mol[order[1]] / mol[order[0]],
                      2 ** -0.6 * np.exp(-(2 / 40) * (1 + 2 / 40))
                      / np.exp(-(1 / 40) * (1 + 1 / 40)))
    assert worlds.expression(lens, {"law": "flat"}) is None
    rng = np.random.default_rng(0)
    t, _, _ = worlds.draw_fragments(rng, lens, 200_000, NORMAL, share)
    got = np.bincount(t, minlength=len(lens)) / 200_000
    assert np.abs(got - share).max() < 0.01


def test_structure_classes_are_the_isoforms_holding_the_run():
    """A fragment's class is exactly the isoforms of its gene whose
    sequence holds the fragment's."""
    w = worlds.make_world(config("gencode", transcripts=400))
    rng = np.random.default_rng(4)
    t, p, fl = worlds.draw_fragments(rng, w["lens"], 300, NORMAL)
    labels, counts = eqsample.fragment_classes(w, t, p, fl)
    assert counts.sum() == 300
    seqs = worlds.world_seqs(w)
    for i in range(300):
        (lab,), _ = eqsample.fragment_classes(w, t[i:i + 1], p[i:i + 1],
                                              fl[i:i + 1])
        assert lab in labels
        frag = seqs[t[i]][p[i]:p[i] + fl[i]].tobytes()
        same_gene = np.nonzero(w["gene_of"] == w["gene_of"][t[i]])[0]
        assert set(lab) == {int(j) for j in same_gene
                            if frag in seqs[j].tobytes()}
