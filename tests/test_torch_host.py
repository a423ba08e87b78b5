"""The port's own host modules against their counterparts in the JAX
package: the same inputs, generated from a seed with numpy, go through
both, and the results are equal (exact unless a tolerance is stated)."""

import dataclasses
import gzip
import os

import numpy as np
import pytest

import sailfish_tpu.cli as jcli
import sailfish_tpu.dna as jdna
import sailfish_tpu.eqclass.classes as jcls
import sailfish_tpu.eqclass.io as jeqio
import sailfish_tpu.index.builder as jbuilder
import sailfish_tpu.index.kmerhash as jkh
import sailfish_tpu.io.fasta as jfasta
import sailfish_tpu.io.fastq as jfq
import sailfish_tpu.libformat as jlf
import sailfish_tpu.output.genemap as jgm
import sailfish_tpu.output.writers as jwr
import sailfish_tpu.stats.fld as jfld
from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.refimpl.mapper import RefMapper as JaxRefMapper
import sailfish_tpu_torch.cli as pcli
import sailfish_tpu_torch.dna as pdna
import sailfish_tpu_torch.eqclass.classes as pcls
import sailfish_tpu_torch.eqclass.io as peqio
import sailfish_tpu_torch.index.builder as pbuilder
import sailfish_tpu_torch.index.kmerhash as pkh
import sailfish_tpu_torch.io.fasta as pfasta
import sailfish_tpu_torch.io.fastq as pfq
import sailfish_tpu_torch.io.native as pnative
import sailfish_tpu_torch.libformat as plf
import sailfish_tpu_torch.output.genemap as pgm
import sailfish_tpu_torch.output.writers as pwr
import sailfish_tpu_torch.stats.fld as pfld
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.refimpl.mapper import RefMapper

from torch_port import port_index, read_text, write_fasta, write_fastq
from torch_port import one_torch_thread  # noqa: F401  (autouse)

_INDEX_ARRAYS = ("codes", "sa", "packed16", "sep_dist", "table_lo",
                 "txp_of_pos", "txp_offsets", "txp_lens")
_HT_ARRAYS = ("ht_key0", "ht_key1", "ht_lo", "ht_cnt")


def _assert_same_index(a, b):
    assert (a.k, a.prefix_bases, a.names) == (b.k, b.prefix_bases, b.names)
    for f in _INDEX_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in _HT_ARRAYS:
        assert a.kmer_ht[f].dtype == b.kmer_ht[f].dtype, f
        np.testing.assert_array_equal(a.kmer_ht[f], b.kmer_ht[f], err_msg=f)
    for f in ("ht_bits", "max_probes"):
        assert a.kmer_ht[f] == b.kmer_ht[f], f


@pytest.fixture(scope="module")
def fasta(toy_world, tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    return write_fasta(str(d / "txps.fa"), toy_world["names"],
                       toy_world["seqs"])


def test_dna_codecs_match():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, 300).astype(np.uint8)
    text = "ACGTNacgtuRYK" * 7
    np.testing.assert_array_equal(pdna.encode(text), jdna.encode(text))
    assert pdna.decode(codes) == jdna.decode(codes)
    np.testing.assert_array_equal(pdna.revcomp(codes), jdna.revcomp(codes))
    clean = codes % 4
    for k in (5, 17, 31):
        assert pdna.kmer_index(clean, k) == jdna.kmer_index(clean, k)
        assert pdna.kmer_index_rc(clean, k) == jdna.kmer_index_rc(clean, k)
        np.testing.assert_array_equal(pdna.rolling_kmer_indices(codes, k),
                                      jdna.rolling_kmer_indices(codes, k))
    for sub in (0, 3):
        np.testing.assert_array_equal(pdna.pack_words_u32(codes, sub=sub),
                                      jdna.pack_words_u32(codes, sub=sub))


def test_library_formats_match():
    names = sorted(jlf.all_named_formats())
    assert sorted(plf.all_named_formats()) == names and len(names) == 12
    for name in names:
        pe, je = plf.parse_library_format(name), jlf.parse_library_format(name)
        assert (int(pe.type), int(pe.orientation), int(pe.strandedness)) \
            == (int(je.type), int(je.orientation), int(je.strandedness))
        assert pe.format_id() == je.format_id() and pe.name == je.name
        assert plf.se_compat_flags(pe) == jlf.se_compat_flags(je)
        for status in range(4):
            for fwd in (True, False):
                assert plf.compatible_hit_single(
                    pe, fwd, plf.MateStatus(status)) \
                    == jlf.compatible_hit_single(
                        je, fwd, jlf.MateStatus(status))
        for other in names:
            assert plf.compatible_hit_paired(
                pe, plf.parse_library_format(other)) \
                == jlf.compatible_hit_paired(
                    je, jlf.parse_library_format(other))
    for args in [(10, True, 50, 100, False, 50), (100, False, 50, 10, True, 50),
                 (10, True, 50, 30, True, 50), (10, False, 50, 12, True, 60)]:
        for dovetail in (False, True):
            p = plf.hit_type(*args, dovetail)
            j = jlf.hit_type(*args, dovetail)
            assert p.format_id() == j.format_id()
    with pytest.raises(ValueError):
        plf.parse_library_format("XX")


def test_config_matches_and_validates():
    """Every field of the port's QuantOpts exists in the JAX package's
    with the same default; the TPU-only knobs have no field; the port
    validates what it acts on (the JAX package accepts any string)."""
    jf = {f.name: f for f in dataclasses.fields(JaxOpts)}
    po, jo = QuantOpts(), JaxOpts()
    for f in dataclasses.fields(QuantOpts):
        assert f.name in jf, f.name
        assert getattr(po, f.name) == getattr(jo, f.name), f.name
    assert not {"kernel", "escalation_backend", "use_xscan",
                "xscan_schedule"} & {f.name for f in
                                     dataclasses.fields(QuantOpts)}
    for L in (56, 104, 304):
        assert po.effective_scan_steps(L) == jo.effective_scan_steps(L)
    o = dict(hit_capacity=2, hit_capacity_max=16, mates1=["a"], mates2=["b"])
    assert QuantOpts(**o).effective_hit_capacity() \
        == JaxOpts(**o).effective_hit_capacity()
    assert QuantOpts(**o).read_libraries() == JaxOpts(**o).read_libraries()
    JaxOpts(mmp_skip="hop", escalation_backend="anything")   # accepted there
    with pytest.raises(ValueError, match="mmp_skip"):
        QuantOpts(mmp_skip="hop")
    with pytest.raises(TypeError):
        QuantOpts(escalation_backend="anything")


def test_index_build_bit_equal(toy_world, fasta):
    jn, js = jfasta.read_fasta(fasta)
    pn, ps = pfasta.read_fasta(fasta)
    assert pn == jn == toy_world["names"]
    for a, b in zip(ps, js):
        np.testing.assert_array_equal(a, b)
    _assert_same_index(pbuilder.build_index_from_fasta(fasta, k=31),
                       jbuilder.build_index_from_fasta(fasta, k=31))
    _assert_same_index(port_index(toy_world["idx"]), toy_world["idx"])
    small_p = pbuilder.build_index(pn[:3], ps[:3], k=17, prefix_bases=6,
                                   ht_min_bits=9)
    small_j = jbuilder.build_index(jn[:3], js[:3], k=17, prefix_bases=6,
                                   ht_min_bits=9)
    _assert_same_index(small_p, small_j)


@pytest.mark.parametrize("native", [True, False])
def test_suffix_array_native_and_numpy_agree(monkeypatch, native):
    """Both suffix-array constructions of the port give the JAX
    package's suffix array (its builder takes the native one here)."""
    rng = np.random.default_rng(3)
    text = rng.integers(0, 4, 5000).astype(np.uint8)
    text[::97] = 0
    want = jbuilder.build_suffix_array(text)
    if native:
        assert pnative.native_sais_available()
    else:
        monkeypatch.setattr(pbuilder, "native_build_sa", lambda t: None)
    got = pbuilder.build_suffix_array(text)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_index_round_trip_across_packages(toy_world, tmp_path, writer):
    """An index directory written by either package loads in the other,
    bit-equal (`index` of one CLI, `quant -i` of the other)."""
    d = str(tmp_path / "idx")
    if writer == "jax":
        jbuilder.save_index(toy_world["idx"], d)
        _assert_same_index(pbuilder.load_index(d), toy_world["idx"])
    else:
        pbuilder.save_index(port_index(toy_world["idx"]), d)
        _assert_same_index(jbuilder.load_index(d), toy_world["idx"])
    own = (pbuilder if writer == "torch" else jbuilder).load_index(d)
    _assert_same_index(own, toy_world["idx"])
    assert sorted(os.listdir(d)) == ["arrays", "header.json",
                                     "txp_names.txt", "versionInfo.json"]


def test_kmer_table_matches(toy_world):
    idx = toy_world["idx"]
    for k in (17, 31):
        p = pkh.build_kmer_table(idx.packed16, idx.sa, k)
        j = jkh.build_kmer_table(idx.packed16, idx.sa, k)
        assert set(p) == set(j)
        for key in p:
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    np.testing.assert_array_equal(pkh.sep_distances(idx.codes),
                                  jkh.sep_distances(idx.codes))
    rng = np.random.default_rng(1)
    k0, k1 = rng.integers(0, 2**32, (2, 64), dtype=np.uint64)
    np.testing.assert_array_equal(pkh.mix_hash_u32(k0, k1),
                                  jkh.mix_hash_u32(k0, k1))


def _fastq_files(toy_world, d, n=300):
    """Mate files with an N in some reads, a few longer reads (forces a
    re-pad) and a gzip copy of mate 1."""
    r1, r2, _ = toy_world["sim"](n, seed=21)
    rng = np.random.default_rng(2)
    for i in range(0, n, 9):
        r1[i][int(rng.integers(0, 50))] = 4
    s = toy_world["seqs"][7]
    for i in (n // 2, n - 3):
        r1[i], r2[i] = s[:70].copy(), jdna.revcomp(s[100:170]).copy()
    p1 = write_fastq(os.path.join(d, "r1.fq"), r1)
    p2 = write_fastq(os.path.join(d, "r2.fq"), r2)
    with open(p1, "rb") as fh, gzip.open(p1 + ".gz", "wb") as gz:
        gz.write(fh.read())
    return p1, p2


def _collect(it):
    out = []
    for b in it:
        bs = b if isinstance(b, tuple) else (b,)
        out.append([(x.codes.copy(), x.lens.copy()) for x in bs])
    return out


def _assert_same_batches(a, b):
    assert len(a) == len(b) > 0
    for ba, bb in zip(a, b):
        for (ca, la), (cb, lb) in zip(ba, bb):
            assert ca.dtype == cb.dtype and la.dtype == lb.dtype
            np.testing.assert_array_equal(ca, cb)
            np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("gz", [False, True])
def test_fastq_batches_match(toy_world, tmp_path, use_native, gz):
    """Plain and gzip input through the native and the numpy decoder:
    the port's batches equal the JAX package's numpy-decoder batches
    (its native decoder is held to those by its own tests)."""
    p1, p2 = _fastq_files(toy_world, str(tmp_path))
    if use_native:
        assert pnative.native_available()
    src = p1 + ".gz" if gz else p1
    want = _collect(jfq.iter_fastq_batches(src, 64, 56, use_native=False))
    got = _collect(pfq.iter_fastq_batches(src, 64, 56,
                                          use_native=use_native))
    _assert_same_batches(got, want)
    assert max(int(l.max()) for (_, l), in got) == 70   # the re-pad ran
    want = _collect(jfq.iter_paired_fastq_batches(src, p2, 64, 56,
                                                  use_native=False))
    got = _collect(pfq.iter_paired_fastq_batches(
        src, p2, 64, 56, use_native=use_native, decode_threads=2))
    _assert_same_batches(got, want)
    got = _collect(pfq.iter_fastq_batches(src, 32, 56, shard=(1, 3),
                                          use_native=use_native))
    want = _collect(jfq.iter_fastq_batches(src, 32, 56, shard=(1, 3),
                                           use_native=False))
    _assert_same_batches(got, want)


def test_fasta_reads_and_malformed_input(toy_world, tmp_path):
    fa = write_fasta(str(tmp_path / "reads.fa"),
                     [f"r{i}" for i in range(5)], toy_world["seqs"][:5])
    assert pfq.sniff_read_format(fa) == jfq.sniff_read_format(fa) == "fasta"
    _assert_same_batches(_collect(pfq.iter_fastq_batches(fa, 2, 904)),
                         _collect(jfq.iter_fastq_batches(fa, 2, 904)))
    bad = tmp_path / "bad.fq"
    bad.write_text("@r0\nACGT\n+\nIIII\nACGT\n+\nIIII\n")
    for use_native in (True, False):
        with pytest.raises(IOError):
            _collect(pfq.iter_fastq_batches(str(bad), 8, 8,
                                            use_native=use_native))


def _random_labels(seed, n=200):
    rng = np.random.default_rng(seed)
    labels = [tuple(sorted(rng.integers(0, 8, int(rng.integers(1, 5)))
                           .tolist())) for _ in range(n)]
    counts = rng.integers(1, 50, n)
    keys = np.array([hash(l) & (2**64 - 1) for l in labels], dtype=np.uint64)
    return labels, counts, keys


def test_eq_class_accumulators_and_dump_match(toy_world, tmp_path):
    labels, counts, keys = _random_labels(5)
    accs = []
    for mod in (pcls, jcls):
        acc = mod.HashedEqClassAccumulator()
        for s in (slice(0, 120), slice(80, 200)):     # overlapping batches
            new = acc.add_hashed(keys[s], counts[s])
            first = {}
            for i in np.nonzero(new)[0]:              # one row per new key
                first.setdefault(int(keys[s][i]), i)
            rows = np.array(sorted(first.values()), dtype=np.int64)
            dup = np.setdiff1d(np.nonzero(new)[0], rows)
            acc.register_new(keys[s][rows], [labels[s][i] for i in rows],
                             counts[s][rows])
            assert not acc.add_hashed(keys[s][dup], counts[s][dup]).any()
        plain = mod.EqClassAccumulator()
        plain.add_many(labels, counts)
        plain.merge(acc)
        accs.append((acc, plain))
    (pa, pp), (ja, jp) = accs
    assert pa._counts == ja._counts and pp._counts == jp._counts
    pe, je = pp.finish(), jp.finish()
    assert pe.num_classes == je.num_classes > 0
    assert pe.total_count() == je.total_count()
    for f in ("class_sizes", "class_of_member"):
        np.testing.assert_array_equal(getattr(pe, f)(), getattr(je, f)())
    names = toy_world["names"]
    fp, fj = str(tmp_path / "p.txt"), str(tmp_path / "j.txt")
    peqio.write_eq_dump(fp, names, pe)
    jeqio.write_eq_dump(fj, names, je)
    assert read_text(fp) == read_text(fj)
    (n1, e1), (n2, e2) = peqio.read_eq_classes(fj), jeqio.read_eq_classes(fp)
    assert n1 == n2 == names
    assert list(e1.labels()) == list(e2.labels()) == list(je.labels())
    pm = peqio.merge_eq_dumps([fp, fj])[1]
    jm = jeqio.merge_eq_dumps([fp, fj])[1]
    assert pm.total_count() == jm.total_count() == 2 * je.total_count()


@pytest.mark.parametrize("case", [
    dict(num_observed=10000, use_unsmoothed=False, paired_end=True),
    dict(num_observed=10000, use_unsmoothed=True, paired_end=True),
    dict(num_observed=50, use_unsmoothed=False, paired_end=True),
    dict(num_observed=10000, use_unsmoothed=False, paired_end=False),
])
def test_effective_lengths_match(case):
    """rtol 1e-12: the same numpy arithmetic in both packages."""
    rng = np.random.default_rng(9)
    ref_lens = rng.integers(40, 3000, 64).astype(np.int64)
    hist = np.bincount(
        np.clip(rng.normal(250, 30, 10000).astype(np.int64), 0, 999),
        minlength=1000).astype(np.int64)
    kw = dict(num_required=10000, fld_mean=200, fld_sd=80,
              max_frag_len=1000, **case)
    pe, ph = pfld.effective_lengths_from_fld(ref_lens, hist, **kw)
    je, jh = jfld.effective_lengths_from_fld(ref_lens, hist, **kw)
    np.testing.assert_allclose(pe, je, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(ph, jh)
    vals = np.arange(len(ph), dtype=np.int64)
    pr = pfld.EmpiricalDistribution(vals, ph.astype(np.int64)).realize(
        np.random.default_rng(4))
    jr = jfld.EmpiricalDistribution(vals, jh.astype(np.int64)).realize(
        np.random.default_rng(4))
    np.testing.assert_array_equal(pr, jr)


def test_quant_writer_files_byte_equal(toy_world, tmp_path):
    rng = np.random.default_rng(12)
    names = toy_world["names"]
    ref_lens = np.array([len(s) for s in toy_world["seqs"]], dtype=np.int64)
    eff = ref_lens - rng.random(8) * 100
    alphas = rng.random(8) * 1000
    labels, counts, _ = _random_labels(6, n=40)
    fmt_counts = np.zeros(64, dtype=np.int64)
    fmt_counts[[5, 21, 22]] = (90, 7, 3)
    gmap = tmp_path / "t2g.tsv"
    gmap.write_text("".join(f"{n}\tg{i // 3}\n" for i, n in enumerate(names)))
    outs = []
    for tag, wr, cls, gm in (("p", pwr, pcls, pgm), ("j", jwr, jcls, jgm)):
        d = str(tmp_path / tag)
        acc = cls.EqClassAccumulator()
        acc.add_many(labels, counts)
        w = wr.QuantWriter(d, "aux")
        w.write_cmd_info([("command", "quant"), ("libType", "IU")])
        w.write_abundances(names, ref_lens, eff, alphas, 1234.0)
        w.write_lib_format_counts("IU", fmt_counts, 90, 100, 120)
        w.write_equiv_counts(names, acc.finish())
        w.write_meta(names=names, fld_hist=np.arange(1000, dtype=np.int32),
                     num_processed=120, num_mapped=100, num_bootstraps=0,
                     num_gibbs_samples=0, bias_correct=False,
                     start_time="now", timings={"mapping_seconds": 1.5})
        w.close()
        gm.generate_gene_level_estimates(str(gmap), d, "gene_id")
        outs.append(d)
    files = sorted(os.path.relpath(os.path.join(r, f), outs[0])
                   for r, _, fs in os.walk(outs[0]) for f in fs)
    assert {"quant.sf", "quant.genes.sf", "cmd_info.json",
            "lib_format_counts.json", "aux/eq_classes.txt",
            "aux/meta_info.json", "aux/fld.gz"} <= set(files)
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(os.path.join(outs[0], f), "rb") as a, \
                opener(os.path.join(outs[1], f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("lib,kw", [
    ("IU", {}), ("ISF", {"allow_dovetail": True}),
    ("OU", {"allow_orphans": False}), ("U", {}), ("SR", {}),
    ("IU", {"hit_capacity": 2, "hit_capacity_max": 0}),
    ("IU", {"strict_intersect": True, "mmp_skip": "jump"}),
])
def test_ref_mapper_hits_match(toy_world, lib, kw):
    r1, r2, _ = toy_world["sim"](48, err_rate=0.4, seed=31)
    r1[3][7] = 4
    pm = RefMapper(port_index(toy_world["idx"]), QuantOpts(**kw))
    jm = JaxRefMapper(toy_world["idx"], JaxOpts(**kw))
    pexp, jexp = plf.parse_library_format(lib), jlf.parse_library_format(lib)
    mapped = 0
    for a, b in zip(r1, r2):
        if pexp.type == plf.ReadType.PAIRED_END:
            p = pm.map_fragment_pe(a, b, pexp)
            j = jm.map_fragment_pe(a, b, jexp)
        else:
            p = pm.map_fragment_se(a, pexp)
            j = jm.map_fragment_se(a, jexp)
        for f in ("label", "num_joint_hits", "frag_len", "unique_paired",
                  "num_fwd", "num_rc", "fmt_id", "compat"):
            assert getattr(p, f) == getattr(j, f), f
        assert [dataclasses.astuple(h) for h in p.joint] \
            == [dataclasses.astuple(h) for h in j.joint]
        mapped += p.label is not None
    assert mapped > 10


def _parse(mod, argv):
    import argparse

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="command", required=True)
    mod._add_index_parser(sub)
    mod._add_quant_parser(sub)
    return parser.parse_args(argv)


def test_cli_parsers_accept_the_same_flags():
    """The port's `index` and `quant` parsers take every flag of the JAX
    CLI's with the same defaults; `--device` is the port's one addition."""
    quant = ["quant", "-i", "idx", "-l", "ISF", "-1", "a.fq", "b.fq", "-2",
             "c.fq", "d.fq", "-o", "out", "--dumpEq", "--useVBOpt", "-w",
             "100", "--kernel", "pallas", "--noXscan", "--xscanT", "5",
             "--hitCapacityMax", "256", "--mmpSkip", "jump", "-p", "2",
             "--fldMean", "180", "--geneMap", "g.tsv", "--seed", "3"]
    for argv in (["index", "-t", "x.fa", "-o", "i", "-k", "21", "-f"],
                 quant, ["quant", "-i", "i", "-l", "U", "-r", "r.fq",
                         "-o", "o"]):
        p, j = vars(_parse(pcli, argv)), vars(_parse(jcli, argv))
        extra = {"device"} if argv[0] == "quant" else set()
        assert set(p) - set(j) == extra and not set(j) - set(p)
        assert {k: v for k, v in p.items() if k not in extra} == j
    assert _parse(pcli, quant).device == "cuda"
    assert _parse(pcli, quant + ["--device", "cpu"]).device == "cpu"
    multi = ["quant", "-i", "i", "-o", "o", "-l", "IU", "-1", "a", "-2", "b",
             "-l", "U", "-r", "c"]
    assert pcli._flatten_read_args(_parse(pcli, multi), multi) \
        == jcli._flatten_read_args(_parse(jcli, multi), multi)
    assert pcli.extract_read_libraries(multi) \
        == jcli.extract_read_libraries(multi)
