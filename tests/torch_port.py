"""Helpers of the tests/test_torch_*.py files: hand the JAX package's
objects to the port as plain numpy arrays and scalars, so that one index
or batch, built once, goes through both implementations."""

import os

import numpy as np
import pytest

from sailfish_tpu import dna
from sailfish_tpu_torch.index.builder import QuasiIndex
from sailfish_tpu_torch.io.fastq import FastqBatch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tests' tensors are too small to gain from torch's intra-op
    threads, and under pytest-xdist those threads fight the other
    workers for the cores (a test of thousands of small ops ran a
    hundred times slower there than alone).  A test module that imports
    this fixture runs torch on one thread."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_index(idx) -> QuasiIndex:
    """The port's QuasiIndex over the arrays of a sailfish_tpu index."""
    return QuasiIndex.from_arrays(
        k=idx.k, names=idx.names, codes=idx.codes, sa=idx.sa,
        txp_of_pos=idx.txp_of_pos, txp_offsets=idx.txp_offsets,
        txp_lens=idx.txp_lens, kmer_ht=idx.kmer_ht,
        prefix_bases=idx.prefix_bases)


def risk_reads(seqs, k, L, seed):
    """Reads that a windowed, chunked scan can get wrong, cut from the
    transcripts `seqs` (uint8 code arrays in text order, each at least L
    bases): (codes (n, L) uint8 padded with code 4, lens (n,) int32).

      - ragged lengths: k - 1, k, L - 1, L and some between
      - reads that end on the last base of the last transcript, and reads
        that run past it (their match ends at the text's final separator)
      - an N at the first, the 16th and the last base of a k-mer, and at
        the read's last base
      - a read across two transcripts with an N where the text has its
        separator: an N ends a match even against a text code 4
      - a substitution every 33 bases, so that under 17 <= k <= 31 only
        a few k-mers per read are in the table and the miss chains
        between them cross a 32-position probe window
      - clean reads, which map on their first probe
    chip_smoke.py carries a copy of this function."""
    rng = np.random.default_rng(seed)
    out = []

    def cut(n):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - n + 1))
        return s[p:p + n].copy()

    for n in (k - 1, k, k + 1, L - 1, L, (k + L) // 2):
        out += [cut(n) for _ in range(3)]
    last = seqs[-1]
    for n in (L, L - 1, k, k + 9):
        out.append(last[len(last) - n:].copy())
    for keep in (k, k + 5, L // 2):
        tail = rng.integers(0, 4, L - keep).astype(np.uint8)
        out.append(np.concatenate([last[len(last) - keep:], tail]))
    for p0 in (0, 7, L - k):
        for at in (p0, p0 + 15, p0 + k - 1):
            m = cut(L)
            m[at] = 4
            out.append(m)
    for n in (L, L - 3):
        m = cut(n)
        m[n - 1] = 4
        out.append(m)
    for t in (0, int(rng.integers(0, len(seqs) - 1))):
        m = np.concatenate([seqs[t][len(seqs[t]) - k - 9:], [4],
                            seqs[t + 1][:L - k - 10]]).astype(np.uint8)
        out.append(m)
    for first in (16, 0, 32):
        for _ in range(3):
            m = cut(L)
            m[first::33] = (m[first::33] + 1) % 4
            out.append(m)
    out += [cut(L) for _ in range(4)]
    codes = np.full((len(out), L), 4, np.uint8)
    for i, m in enumerate(out):
        codes[i, :len(m)] = m
    return codes, np.array([len(m) for m in out], np.int32)


def port_batch(b) -> FastqBatch:
    return FastqBatch(codes=np.asarray(b.codes), lens=np.asarray(b.lens))


def port_slots(slots) -> dict:
    """The joint-hit slots of sailfish_tpu's merge_and_collapse
    (return_slots=True) as torch tensors."""
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in slots.items()}


def jax_eq(eq):
    """A sailfish_tpu EqClasses over the arrays of the port's."""
    from sailfish_tpu.eqclass.classes import EqClasses

    return EqClasses(members=np.array(eq.members), offsets=np.array(eq.offsets),
                     counts=np.array(eq.counts))


BIAS_VECTORS = ("read_bias_counts", "observed_gc", "expected_seq_bias",
                "expected_gc")


def copy_bias(src, dst):
    """The observed and expected vectors of one package's BiasState into
    the other's; returns dst."""
    for f in BIAS_VECTORS:
        setattr(dst, f, np.copy(getattr(src, f)))
    return dst


def hit_blocks(pidx, batches, cand_cap):
    """The port's oriented hit blocks (fw, rc) of each batch in
    `batches` on the CPU."""
    import torch

    from sailfish_tpu_torch.index.device import TorchIndex
    from sailfish_tpu_torch.map.lanes import map_oriented_lanes

    tidx = TorchIndex.from_quasi_index(pidx, "cpu")
    out = []
    for b in batches:
        h = map_oriented_lanes(tidx, torch.from_numpy(b.codes),
                               torch.from_numpy(b.lens), cand_cap=cand_cap,
                               max_mmps=4, max_steps=b.codes.shape[1])
        n = b.codes.shape[0]
        out.append(tuple({k: v[s] for k, v in h.items()
                          if k != "num_mapped_loci"}
                         for s in (slice(0, n), slice(n, 2 * n))))
    return out


def write_fasta(path, names, seqs):
    with open(path, "w") as fh:
        for name, s in zip(names, seqs):
            fh.write(f">{name}\n{dna.decode(s)}\n")
    return path


def write_fastq(path, reads, tag=""):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            s = dna.decode(r)
            fh.write(f"@f{i}{tag}\n{s}\n+\n{'I' * len(s)}\n")
    return path


def write_world(toy_world, d, n=400, seed=5, **sim_kw):
    """transcripts FASTA + the two mate FASTQ files of `n` simulated
    fragments in directory `d`."""
    fasta = write_fasta(os.path.join(d, "txps.fa"), toy_world["names"],
                        toy_world["seqs"])
    r1, r2, _ = toy_world["sim"](n, err_rate=0.3, seed=seed, **sim_kw)
    paths = [write_fastq(os.path.join(d, f"r{m}.fq"), reads, f"/{m}")
             for m, reads in ((1, r1), (2, r2))]
    return fasta, paths


def done_stats(out):
    """The `done: {...}` record of a CLI run's log file."""
    import json

    with open(os.path.join(out, "logs", "sailfish_quant.log")) as fh:
        lines = [ln for ln in fh if "done: " in ln]
    return json.loads(lines[-1].split("done: ", 1)[1])


def read_quant_sf(path):
    with open(path) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh][1:]
    names = [r[0] for r in rows]
    num = np.array([[float(x) for x in r[1:]] for r in rows])
    return names, num


def read_text(path):
    with open(path) as fh:
        return fh.read()


def run_both_clis(monkeypatch, idx, out_dir, lib, reads, flags=()):
    """`quant --dumpEq` of the JAX CLI (kernel xla) and of the port's
    (--device cpu) on the same index directory and reads.  Returns, per
    package, the output directory and the statistics `run_quant` returned
    (alphas, eff_lens, em_iterations, ...), caught on their way to the
    CLI, which logs only the scalar ones."""
    import sailfish_tpu.quant as jquant
    import sailfish_tpu_torch.quant as pquant
    from sailfish_tpu.cli import main as jax_main
    from sailfish_tpu_torch.cli import main as torch_main

    # no persistent jax compilation cache from inside the test process
    monkeypatch.setenv("SAILFISH_TPU_COMPILE_CACHE", "")
    got = {}

    def recording(tag, fn):
        def run(*a, **kw):
            got[tag] = fn(*a, **kw)
            return got[tag]
        return run

    monkeypatch.setattr(jquant, "run_quant",
                        recording("jax", jquant.run_quant))
    monkeypatch.setattr(pquant, "run_quant",
                        recording("torch", pquant.run_quant))
    outs = {}
    for tag, main, extra in (("jax", jax_main, ["--kernel", "xla"]),
                             ("torch", torch_main, ["--device", "cpu"])):
        outs[tag] = os.path.join(out_dir, f"q_{tag}")
        assert main(["quant", "-i", idx, "-l", lib, *reads, "-o", outs[tag],
                     "--dumpEq", "--batchSize", "128", *flags, *extra]) == 0
    return outs, got


def assert_same_quant(outs, got):
    """eq_classes.txt identical, EM iterations equal, effective lengths
    and alphas at rtol 1e-9 (both run the same float64 arithmetic, in
    another order of summation), quant.sf names and lengths equal."""
    eq_t = read_text(os.path.join(outs["torch"], "aux", "eq_classes.txt"))
    assert eq_t == read_text(os.path.join(outs["jax"], "aux",
                                          "eq_classes.txt"))
    assert int(eq_t.split("\n")[1]) > 0
    j, t = got["jax"], got["torch"]
    assert t["em_iterations"] == j["em_iterations"] > 0
    assert t["num_mapped"] == j["num_mapped"] > 0
    assert t["num_observed"] == j["num_observed"]
    np.testing.assert_allclose(t["eff_lens"], np.asarray(j["eff_lens"]),
                               rtol=1e-9, atol=0)
    np.testing.assert_allclose(t["alphas"], np.asarray(j["alphas"]),
                               rtol=1e-9, atol=1e-12)
    names_j, qj = read_quant_sf(os.path.join(outs["jax"], "quant.sf"))
    names_t, qt = read_quant_sf(os.path.join(outs["torch"], "quant.sf"))
    assert names_t == names_j
    np.testing.assert_array_equal(qt[:, :1], qj[:, :1])
    # quant.sf prints 6 significant digits
    np.testing.assert_allclose(qt[:, 1:], qj[:, 1:], rtol=1e-5, atol=0)
    assert abs(qt[:, 2].sum() - 1e6) < 10.0
    for f in ("lib_format_counts.json", "aux/quant_state.json"):
        a, b = (read_text(os.path.join(outs[k], f)) for k in ("torch", "jax"))
        assert a == b, f
