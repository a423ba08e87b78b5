"""The host fold at many classes, and the counters it keeps
(sailfish_tpu_torch/trace.py): a spliced world whose isoforms share
exons, paired fragments drawn flat over the transcripts, several batches
that each bring new classes, through the device backend on the CPU.
The hashed fold (`finish_batch_fast` into a HashedEqClassAccumulator)
gives the classes and counts of the exact path (`finish_batch`) and of
`--backend refimpl`; `map.fold_classes`, `map.new_classes` and
`map.label_bytes` count what each fold was handed."""

import json
import os

import numpy as np
import pytest

from sailfish_tpu_torch import dna, trace
from sailfish_tpu_torch.cli import main
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.eqclass.classes import (EqClassAccumulator,
                                                HashedEqClassAccumulator)
from sailfish_tpu_torch.index.builder import build_index
from sailfish_tpu_torch.io.fastq import FastqBatch
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.pipeline import (DeviceMapperBackend,
                                             RefMapperBackend)
from torch_port import one_torch_thread  # noqa: F401  (autouse)

READ = 50
BATCHES, BATCH = 5, 128


def _spliced_world(seed=21, genes=20, exons=7, isoforms=4):
    """Genes of random exons; each isoform keeps the first and last exon
    and a distinct subset of the others, so isoforms share exons."""
    rng = np.random.default_rng(seed)
    names, seqs = [], []
    for g in range(genes):
        ex = [rng.integers(0, 4, int(rng.integers(60, 160))).astype(np.uint8)
              for _ in range(exons)]
        masks = set()
        while len(masks) < isoforms:
            keep = rng.random(exons - 2) < 0.6
            masks.add(tuple([True, *keep.tolist(), True]))
        for i, m in enumerate(sorted(masks)):
            names.append(f"g{g}.i{i}")
            seqs.append(np.concatenate([e for e, k in zip(ex, m) if k]))
    return names, seqs


def _flat_batches(seqs, seed=5):
    """Paired fragments, each transcript equally likely, lengths N(200,
    20) clipped to the transcript; mate 2 reverse-complemented."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(BATCHES):
        m1 = np.full((BATCH, 56), 4, np.uint8)
        m2 = m1.copy()
        for i in range(BATCH):
            s = seqs[int(rng.integers(0, len(seqs)))]
            fl = int(np.clip(rng.normal(200, 20), READ, len(s)))
            p = int(rng.integers(0, len(s) - fl + 1))
            m1[i, :READ] = s[p:p + READ]
            m2[i, :READ] = dna.revcomp(s[p + fl - READ:p + fl])
        lens = np.full(BATCH, READ, np.int32)
        out.append((FastqBatch(m1, lens), FastqBatch(m2, lens)))
    return out


@pytest.fixture(scope="module")
def world():
    names, seqs = _spliced_world()
    return names, seqs, build_index(names, seqs, k=31), _flat_batches(seqs)


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


def test_hashed_fold_counts_match_the_exact_paths(world, fresh):
    names, seqs, idx, batches = world
    exp = parse_library_format("IU")
    dev = DeviceMapperBackend(idx, QuantOpts(), "cpu")
    ref = RefMapperBackend(idx, QuantOpts())
    fast, exact, oracle = (dev.accumulator(), EqClassAccumulator(),
                           ref.accumulator())
    new_per_batch = []
    for b1, b2 in batches:
        br = dev.finish_batch(dev.submit_pe(b1, b2, exp))
        exact.add_many(br.labels, br.label_counts)
        tok = dev.submit_pe(b1, b2, exp)
        itemsize = tok[0]["label"].element_size()
        before, seen = trace.aggregates(), set(fast._counts)
        dev.finish_batch_fast(tok, fast)
        got = trace.aggregates(before)["counters"]
        added = set(fast._counts) - seen
        assert got["map.fold_classes"] == len(br.labels)
        assert got.get("map.new_classes", 0) == len(added)
        width = max((len(lab) for lab in added), default=0)
        assert got.get("map.label_bytes", 0) == len(added) * width * itemsize
        new_per_batch.append(len(added))
    assert min(new_per_batch) > 0, new_per_batch
    # every transcript expressed: more classes than transcripts, some
    # holding several isoforms of a gene
    assert len(fast) > len(names)
    assert max(len(lab) for lab in fast._counts) > 1
    assert fast._counts == exact._counts
    assert trace.counter("map.new_classes") == len(fast)

    trace.reset()
    for b1, b2 in batches:
        ref.finish_batch_fast(ref.submit_pe(b1, b2, exp), oracle)
    assert oracle._counts == fast._counts
    assert trace.counter("map.new_classes") == len(oracle)


@pytest.mark.parametrize("read_between", [False, True])
def test_hashed_accumulator_against_a_dict(read_between):
    """Keys repeat within and across batches, in any order; counts wait
    in the per-slot array until `_counts` is read, whenever that is."""
    rng = np.random.default_rng(3)
    labels = sorted({tuple(sorted(rng.integers(0, 40, int(rng.integers(1, 5)))
                                  .tolist())) for _ in range(600)})
    keys = rng.integers(0, 2**63, len(labels), dtype=np.int64).astype(
        np.uint64) * np.uint64(2) + np.uint64(1)
    acc, want = HashedEqClassAccumulator(), {}
    for _ in range(8):
        rows = rng.integers(0, len(labels), 300)
        counts = rng.integers(1, 9, len(rows))
        new = acc.add_hashed(keys[rows], counts)
        first = {}
        for i in np.flatnonzero(new):
            first.setdefault(int(rows[i]), i)
        reg = np.array(sorted(first.values()), np.int64)
        acc.register_new(keys[rows[reg]], [labels[r] for r in rows[reg]],
                         counts[reg])
        rest = np.setdiff1d(np.flatnonzero(new), reg)
        assert not acc.add_hashed(keys[rows[rest]], counts[rest]).any()
        for r, c in zip(rows.tolist(), counts.tolist()):
            want[labels[r]] = want.get(labels[r], 0) + c
        if read_between:
            assert acc._counts == want and len(acc) == len(want)
    assert acc._counts == want
    got_keys, got_counts = acc.keyed_counts()
    assert dict(zip(got_keys.tolist(), got_counts.tolist())) == {
        int(keys[labels.index(lab)]): c for lab, c in want.items()}


def _write(path, records):
    with open(path, "w") as fh:
        fh.writelines(records)
    return path


def test_quant_meta_info_carries_the_new_classes(world, tmp_path, fresh):
    """`map.new_classes` in meta_info.json: every class of the run is
    new once, so it equals the classes `--dumpEq` writes."""
    names, seqs, _, batches = world
    fa = _write(tmp_path / "t.fa", [f">{n}\n{dna.decode(s)}\n"
                                    for n, s in zip(names, seqs)])
    fq = []
    for m in (0, 1):
        recs = [f"@f{b}_{i}/{m + 1}\n{dna.decode(c[:READ])}\n+\n{'I' * READ}\n"
                for b, pair in enumerate(batches)
                for i, c in enumerate(pair[m].codes)]
        fq.append(str(_write(tmp_path / f"r{m + 1}.fq", recs)))
    idx, out = str(tmp_path / "idx"), str(tmp_path / "q")
    assert main(["index", "-t", str(fa), "-o", idx, "-k", "31"]) == 0
    assert main(["quant", "-i", idx, "-l", "IU", "-1", fq[0], "-2", fq[1],
                 "-o", out, "--dumpEq", "--batchSize", str(BATCH),
                 "--device", "cpu"]) == 0
    with open(os.path.join(out, "aux", "meta_info.json")) as fh:
        counters = json.load(fh)["quant_timings"]["counters"]
    with open(os.path.join(out, "aux", "eq_classes.txt")) as fh:
        fh.readline()
        n_classes = int(fh.readline())
    assert counters["map.batches"] == BATCHES
    assert counters["map.new_classes"] == n_classes > len(names)
    assert counters["map.fold_classes"] >= n_classes
    assert counters["map.label_bytes"] > 0
