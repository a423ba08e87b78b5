"""The port's bench (sailfish_tpu_torch/bench.py) against the JAX
package's two throughput tools, bench.py and tools/bench_gencode.py,
loaded by path with their module constants set small: the same worlds
and reads bit for bit, the same index, the same eq classes and float32
EM on the uniform world, the output contract, the check's gate and the
refusal to run on the CPU unless asked."""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.eqclass.classes import HashedEqClassAccumulator
from sailfish_tpu.infer.em import run_em as jax_run_em
from sailfish_tpu.io.fastq import FastqBatch as JaxBatch
from sailfish_tpu.libformat import parse_library_format
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu_torch import bench
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.libformat import parse_library_format as port_lib
from sailfish_tpu_torch.map import pipeline

from conftest import to_batch
from torch_port import port_index
from torch_port import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TXPS, BATCHES, BATCH = 50, 3, 256
GENCODE_TXPS = 300
SMALL = ["--device", "cpu", "--batch", str(BATCH), "--check", "64"]
UNIFORM = SMALL + ["--txps", str(TXPS), "--batches", str(BATCHES)]
UNITS = {"reads_per_sec_per_chip": "reads/s",
         "gencode_index_build_s": "s", "gencode_index_load_s": "s",
         "gencode_reads_per_sec": "frags/s",
         "gencode_em_iters_per_sec": "iters/s",
         "gencode_bootstraps_per_sec": "replicates/s",
         "gencode_gibbs_samples_per_sec": "samples/s"}


def _load_tool(name, relpath, **consts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in consts.items():
        setattr(mod, k, v)
    return mod


@pytest.fixture(scope="module")
def jax_uniform():
    """bench.py's world, index and batches at 50 transcripts x 3 batches
    x 256 fragments (no index cache)."""
    tool = _load_tool("jax_bench", "bench.py", NUM_TXPS=TXPS,
                      NUM_BATCHES=BATCHES, BATCH=BATCH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_IDX_CACHE", "")
        rng = np.random.default_rng(0)
        idx, seqs = tool.build_world(rng)
        batches = tool.simulate_batches(seqs, rng)
    return idx, seqs, batches


def _run(argv, fn=None):
    """The bench in this process: (return value or exit code, stdout
    lines).  `fn` runs one world with the parsed flags."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if fn is None:
            ret = bench.main(argv)
        else:
            ret = fn(bench.Bench(bench.parse_args(argv)))
    return ret, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def port_uniform():
    return _run(UNIFORM + ["--cache", ""], bench.run_uniform)


def test_uniform_world_and_batches_equal_bench_py(jax_uniform):
    """(a) The transcripts and the pre-simulated batches bit for bit,
    and the port's k = 31 index equal to the JAX package's."""
    idx, seqs, batches = jax_uniform
    rng = np.random.default_rng(0)
    mine = bench.uniform_seqs(rng, TXPS, 1000)
    assert len(mine) == len(seqs)
    for a, b in zip(mine, seqs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = bench.simulate_uniform(mine, rng, BATCHES, BATCH)
    assert len(got) == len(batches)
    for g, w in zip(got, batches):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    pidx = bench.build_index([f"t{i}" for i in range(TXPS)], mine, k=31)
    assert pidx.names == idx.names and pidx.prefix_bases == idx.prefix_bases
    for f in ("codes", "sa", "packed16", "sep_dist", "table_lo",
              "txp_of_pos", "txp_offsets", "txp_lens"):
        np.testing.assert_array_equal(getattr(pidx, f), getattr(idx, f),
                                      err_msg=f)
    assert pidx.kmer_ht.keys() == idx.kmer_ht.keys()
    for k in idx.kmer_ht:
        np.testing.assert_array_equal(np.asarray(pidx.kmer_ht[k]),
                                      np.asarray(idx.kmer_ht[k]), err_msg=k)


def test_gencode_world_and_batch_equal_bench_gencode():
    """(b) The gene-family world of seed 7 and a batch of seed 11 bit for
    bit at ~300 transcripts; the batch padded as the JAX tool pads it."""
    tool = _load_tool("jax_bench_gencode", "tools/bench_gencode.py",
                      TXPS=GENCODE_TXPS, BASES=150e6)
    names, seqs = tool.build_transcriptome(np.random.default_rng(7))
    pnames, pseqs = bench.build_transcriptome(np.random.default_rng(7),
                                              GENCODE_TXPS, 150e6)
    assert len(seqs) == GENCODE_TXPS and pnames == names
    for a, b in zip(pseqs, seqs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    concat, offs, lens = bench._world_arrays(pseqs)
    want = tool.simulate_batch(np.random.default_rng(11), concat, offs[:-1],
                               lens, BATCH)
    m1, m2 = bench.simulate_batch(np.random.default_rng(11), concat,
                                  offs[:-1], lens, BATCH)
    got = (bench.padded(m1), bench.padded(m2),
           np.full(BATCH, bench.READ_LEN, np.int32))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_uniform_loop_matches_jax_backend_and_em(jax_uniform, port_uniform):
    """(c) The bench's loop on the CPU: its eq classes (labels and
    counts) equal the JAX DeviceMapperBackend's on the same batches
    (kernel "xla", scan_shrink 1, --hitCapacity 64 --hitCapacityMax
    1024), and its float32 EM the JAX float32 EM: the same iteration
    count, alphas at rtol 1e-4."""
    idx, _, batches = jax_uniform
    (eq, em), lines = port_uniform
    jb = JaxBackend(idx, JaxOpts(batch_size=BATCH, hit_capacity=64,
                                 hit_capacity_max=1024, kernel="xla",
                                 scan_shrink=1))
    exp = parse_library_format("IU")
    acc = HashedEqClassAccumulator()
    mapped = 0
    for c1, c2, lens in batches:
        tok = jb.submit_pe(JaxBatch(c1, lens), JaxBatch(c2, lens), exp)
        mapped += jb.finish_batch_fast(tok, acc).num_mapped
    jeq = acc.finish()
    assert (dict(zip(eq.labels(), eq.counts.tolist()))
            == dict(zip(jeq.labels(), jeq.counts.tolist())))
    doc = json.loads(lines[-1])
    assert doc["mapped"] == mapped and doc["reads"] == BATCHES * BATCH
    assert doc["eq_classes"] == jeq.num_classes

    eff = np.maximum(idx.txp_lens.astype(np.float64) - 220.0, 1.0)
    jem = jax_run_em(jeq, eff, float(mapped), idx.num_transcripts,
                     dtype="float32", min_iter=50, max_iter=200)
    assert em.num_iterations == jem.num_iterations
    np.testing.assert_allclose(em.alphas, np.asarray(jem.alphas), rtol=1e-4)


def test_every_line_is_a_named_metric(port_uniform, tmp_path):
    """(d) stdout holds only JSON metric lines with the JAX tools' names
    and units, each naming its device; no `vs_baseline`.  The gencode
    world builds and caches its index with --build-only (only
    gencode_index_build_s), then loads it (gencode_index_load_s), maps
    and runs the samplers."""
    gen = SMALL + ["--world", "gencode", "--txps", str(GENCODE_TXPS),
                   "--reads", str(2 * BATCH), "--cache", str(tmp_path)]
    rc1, built = _run(gen + ["--build-only"])
    rc2, loaded = _run(gen + ["--bootstraps", "2", "--gibbs", "2"])
    assert rc1 == rc2 == 0
    names = []
    for line in port_uniform[1] + built + loaded:
        doc = json.loads(line)
        assert UNITS[doc["metric"]] == doc["unit"], doc
        assert np.isfinite(doc["value"]) and doc["value"] > 0, doc
        assert doc["device"] == "cpu" and "vs_baseline" not in doc
        names.append(doc["metric"])
    assert names == ["reads_per_sec_per_chip", "gencode_index_build_s",
                     "gencode_index_load_s", "gencode_reads_per_sec",
                     "gencode_em_iters_per_sec",
                     "gencode_bootstraps_per_sec",
                     "gencode_gibbs_samples_per_sec"]
    doc = json.loads(loaded[1])
    assert doc["checked"] == 64 and doc["reads"] == 2 * BATCH
    assert json.loads(loaded[0])["world"] == "world.npz"


def test_corrupted_eq_class_fails_the_check(monkeypatch):
    """(e) A fold that loses one fragment of a class makes --check exit
    1 before any metric line."""
    fold = pipeline.DeviceMapperBackend.finish_batch

    def corrupted(self, token):
        br = fold(self, token)
        br.label_counts = br.label_counts.copy()
        br.label_counts[0] -= 1
        return br

    monkeypatch.setattr(pipeline.DeviceMapperBackend, "finish_batch",
                        corrupted)
    rc, lines = _run(UNIFORM + ["--cache", ""])
    assert rc == 1 and lines == []


def test_default_device_is_the_card():
    """(f) Without --device cpu and without a card, the bench raises
    as_device's error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default runs")
    with pytest.raises(RuntimeError, match="is_available"):
        _run(["--txps", "5", "--batches", "1", "--batch", "8",
              "--cache", ""])


def test_oracle_in_forked_workers_equals_one_process(toy_world):
    """(g) The reference mapper over forked workers (the oracle gates on
    the card) gives one process's BatchResult, fragment for fragment,
    paired and single-end."""
    idx = port_index(toy_world["idx"])
    r1, r2, _ = toy_world["sim"](40, err_rate=0.3, seed=23)
    b1, b2 = to_batch(r1), to_batch(r2)
    opts = QuantOpts(hit_capacity=64, hit_capacity_max=1024)
    got = {}
    for workers in (1, 3):
        be = pipeline.RefMapperBackend(idx, opts, workers=workers)
        got[workers] = (be.map_pe_batch(b1, b2, port_lib("IU")),
                        be.map_se_batch(b1, port_lib("U")))
    for one, forked in zip(got[1], got[3]):
        assert one.labels == forked.labels and one.per_read == forked.per_read
        for f in ("label_counts", "mapped", "num_joint", "frag_lens",
                  "fmt_counts"):
            assert np.array_equal(getattr(one, f), getattr(forked, f))
        assert int(one.mapped.sum()) > 0
