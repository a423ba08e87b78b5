"""Helpers of the tests/test_torch_*.py files: hand the JAX package's
objects to the port as plain numpy arrays and scalars, so that one index
or batch, built once, goes through both implementations."""

import os

import numpy as np

from sailfish_tpu import dna
from sailfish_tpu_torch.index.builder import QuasiIndex
from sailfish_tpu_torch.io.fastq import FastqBatch


def port_index(idx) -> QuasiIndex:
    """The port's QuasiIndex over the arrays of a sailfish_tpu index."""
    return QuasiIndex.from_arrays(
        k=idx.k, names=idx.names, codes=idx.codes, sa=idx.sa,
        txp_of_pos=idx.txp_of_pos, txp_offsets=idx.txp_offsets,
        txp_lens=idx.txp_lens, kmer_ht=idx.kmer_ht,
        prefix_bases=idx.prefix_bases)


def port_batch(b) -> FastqBatch:
    return FastqBatch(codes=np.asarray(b.codes), lens=np.asarray(b.lens))


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
