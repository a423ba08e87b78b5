"""The port's CLI against the JAX package's on the toy world, on the
CPU: bias correction, posterior samples, eq-class dumps and resume,
sharded mapping with `mergeeq`, checkpoints and several read libraries
in one run.  The JAX CLI runs three times for the whole file (paired
with --biasCorrect and --numBootstraps, two libraries, and a resume with
--numGibbsSamples); the port's runs are compared with their files."""

import gzip
import json
import os

import numpy as np
import pytest

from sailfish_tpu_torch.eqclass.io import merge_eq_dumps, read_eq_classes

from torch_port import read_quant_sf, read_text, write_world
from torch_port import one_torch_thread  # noqa: F401  (autouse)


def _raw(out, name, dtype):
    with gzip.open(os.path.join(out, "aux", name)) as fh:
        return np.frombuffer(fh.read(), dtype=dtype)


def _meta(out):
    with open(os.path.join(out, "aux", "meta_info.json")) as fh:
        return json.load(fh)


def _eq_text(out):
    return read_text(os.path.join(out, "aux", "eq_classes.txt"))


def _num_reads(out):
    return read_quant_sf(os.path.join(out, "quant.sf"))[1][:, 3]


@pytest.fixture(scope="module")
def runs(toy_world, tmp_path_factory):
    """The world's files, one index, a function that runs the port's CLI
    on the CPU, and the JAX CLI's three runs."""
    from sailfish_tpu.cli import main as jax_main
    from sailfish_tpu_torch.cli import main as torch_main

    d = str(tmp_path_factory.mktemp("resume"))
    fasta, (fq1, fq2) = write_world(toy_world, d, n=600)
    idx = os.path.join(d, "idx")
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "31"]) == 0
    paired = ["-l", "IU", "-1", fq1, "-2", fq2]
    two = [*paired, "-l", "U", "-r", fq1]

    def quant(main, name, reads, *flags):
        out = os.path.join(d, name)
        assert main(["quant", "-i", idx, *reads, "-o", out, "--batchSize",
                     "128", *flags]) == 0
        return out

    def port(name, reads, *flags):
        return quant(torch_main, name, reads, "--device", "cpu", *flags)

    with pytest.MonkeyPatch.context() as mp:
        # no persistent jax compilation cache from inside the test process
        mp.setenv("SAILFISH_TPU_COMPILE_CACHE", "")
        jx = {"bias": quant(jax_main, "j_bias", paired, "--kernel", "xla",
                            "--dumpEq", "--biasCorrect", "--numBootstraps",
                            "2"),
              "two": quant(jax_main, "j_two", two, "--kernel", "xla",
                           "--dumpEq")}
        jx["gibbs"] = quant(jax_main, "j_gibbs", ["-l", "IU"],
                            "--resumeFromEq", jx["bias"],
                            "--numGibbsSamples", "3")
    return {"dir": d, "paired": paired, "two": two, "port": port, "jax": jx,
            "plain": port("p_plain", paired, "--dumpEq")}


def test_bias_correct_matches_jax_cli(runs):
    """--biasCorrect --numBootstraps 2: observed_bias.gz identical,
    expected_bias.gz and NumReads at rtol 1e-6, the same eq classes, and
    meta_info.json says what the JAX run's says."""
    out = runs["port"]("p_bias", runs["paired"], "--dumpEq", "--biasCorrect",
                       "--numBootstraps", "2")
    ref = runs["jax"]["bias"]
    obs = _raw(out, "observed_bias.gz", np.int32)
    np.testing.assert_array_equal(obs, _raw(ref, "observed_bias.gz",
                                            np.int32))
    assert obs.shape == (4096,) and obs.sum() > 4096 + 300
    np.testing.assert_allclose(_raw(out, "expected_bias.gz", np.float64),
                               _raw(ref, "expected_bias.gz", np.float64),
                               rtol=1e-6)
    np.testing.assert_allclose(_num_reads(out), _num_reads(ref), rtol=1e-6)
    assert _eq_text(out) == _eq_text(ref)
    m, mj = _meta(out), _meta(ref)
    for key in ("samp_type", "num_bootstraps", "bias_correct",
                "num_processed", "num_mapped", "num_targets"):
        assert m[key] == mj[key], key
    assert (m["samp_type"], m["bias_correct"]) == ("bootstrap", True)
    assert m["quant_timings"]["bias_samples"] == obs.sum() - 4096
    boots = _raw(out, "bootstrap/bootstraps.gz", np.float64)
    assert boots.shape == (2 * m["num_targets"],)
    np.testing.assert_allclose(boots.reshape(2, -1).sum(axis=1),
                               m["num_mapped"], rtol=1e-6)


def test_gc_bias_runs_and_equals_refimpl_backend(runs):
    """--gcBiasCorrect through the device backend and through the host
    oracle backend write the same observed_gc.gz and quant.sf."""
    outs = [runs["port"](f"p_gc_{b}", runs["paired"], "--gcBiasCorrect",
                         "--backend", b) for b in ("device", "refimpl")]
    gc = [_raw(o, "observed_gc.gz", np.int32) for o in outs]
    np.testing.assert_array_equal(gc[0], gc[1])
    assert gc[0].sum() == _meta(outs[0])["quant_timings"]["bias_gc_slots"]
    assert gc[0].sum() > 300
    assert (read_text(os.path.join(outs[0], "quant.sf"))
            == read_text(os.path.join(outs[1], "quant.sf")))


def test_gc_bias_is_switched_off_for_single_end(runs):
    out = runs["port"]("p_gc_se", runs["two"], "--gcBiasCorrect")
    assert _raw(out, "observed_gc.gz", np.int32).sum() == 0


@pytest.mark.parametrize("source", ["port", "jax"])
def test_resume_equals_the_unresumed_run(runs, source):
    """--resumeFromEq from the port's own dump and from the JAX
    package's dump and quant_state.json: quant.sf equal to the run that
    mapped (the FLD and the counters are restored), nothing mapped."""
    src = runs["plain"] if source == "port" else runs["jax"]["bias"]
    out = runs["port"](f"p_resumed_{source}", ["-l", "IU"], "--resumeFromEq",
                       src, "--dumpEq")
    assert (read_text(os.path.join(out, "quant.sf"))
            == read_text(os.path.join(runs["plain"], "quant.sf")))
    assert _eq_text(out) == _eq_text(runs["plain"])
    for f in ("lib_format_counts.json", "aux/quant_state.json"):
        assert (read_text(os.path.join(out, f))
                == read_text(os.path.join(runs["plain"], f))), f
    t = _meta(out)["quant_timings"]
    assert t["batch_ms"] == [] and t["mapping_seconds"] == 0


def test_resume_with_gibbs_matches_jax_cli(runs):
    """--resumeFromEq --numGibbsSamples 3 from the JAX run's dump: the
    point estimates equal the JAX CLI's resume of the same dump, the
    samples are int32 vectors that sum to the mapped count, and the
    meta file says gibbs."""
    out = runs["port"]("p_gibbs", ["-l", "IU"], "--resumeFromEq",
                       runs["jax"]["bias"], "--numGibbsSamples", "3")
    ref = runs["jax"]["gibbs"]
    np.testing.assert_allclose(_num_reads(out), _num_reads(ref), rtol=1e-6)
    m, mj = _meta(out), _meta(ref)
    for key in ("samp_type", "num_bootstraps", "bias_correct",
                "num_processed", "num_mapped"):
        assert m[key] == mj[key], key
    assert m["samp_type"] == "gibbs"
    samples = _raw(out, "bootstrap/bootstraps.gz", np.int32).reshape(3, -1)
    assert samples.shape[1] == m["num_targets"]
    assert (samples.sum(axis=1) == m["num_mapped"]).all()
    with gzip.open(os.path.join(out, "aux", "bootstrap",
                                "names.tsv.gz")) as fh:
        assert len(fh.read().decode().split("\t")) == m["num_targets"]


def test_shards_merge_to_the_single_run(runs):
    """--numShards 2 --shardId i --mapOnly twice, `mergeeq`, then
    --resumeFromEq of the bare merged dump: the classes of the single
    run; --mapOnly writes the dump and the state and no quant.sf."""
    from sailfish_tpu_torch.cli import main as torch_main

    shards = [runs["port"](f"p_shard{i}", runs["paired"], "--numShards", "2",
                           "--shardId", str(i), "--mapOnly") for i in (0, 1)]
    for s in shards:
        assert not os.path.exists(os.path.join(s, "quant.sf"))
        assert os.path.exists(os.path.join(s, "aux", "quant_state.json"))
    merged = os.path.join(runs["dir"], "merged_eq.txt")
    assert torch_main(["mergeeq", *shards, "-o", merged]) == 0
    assert read_text(merged) == _eq_text(runs["plain"])
    seen = [json.loads(read_text(os.path.join(
        s, "aux", "quant_state.json")))["num_observed"] for s in shards]
    assert sum(seen) == 600 and min(seen) > 0
    out = runs["port"]("p_from_merged", ["-l", "IU"], "--resumeFromEq",
                       merged, "--dumpEq")
    assert _eq_text(out) == _eq_text(runs["plain"])
    m = _meta(out)
    assert m["num_processed"] == m["num_mapped"] == _meta(
        runs["plain"])["num_mapped"]
    assert abs(read_quant_sf(os.path.join(out, "quant.sf"))[1][:, 2].sum()
               - 1e6) < 1.0


def test_two_libraries_match_jax_cli(runs):
    """-l IU -1 .. -2 .. -l U -r ..: eq_classes.txt, lib_format_counts.json
    (the expected format joined with ';') and quant_state.json identical
    to the JAX CLI's, NumReads at rtol 1e-6; and the classes are the sum
    of the two single-library runs' dumps."""
    out = runs["port"]("p_two", runs["two"], "--dumpEq")
    ref = runs["jax"]["two"]
    assert _eq_text(out) == _eq_text(ref)
    for f in ("lib_format_counts.json", "aux/quant_state.json"):
        assert read_text(os.path.join(out, f)) == read_text(
            os.path.join(ref, f)), f
    assert json.loads(read_text(os.path.join(
        out, "lib_format_counts.json")))["expected_format"] == "IU;U"
    np.testing.assert_allclose(_num_reads(out), _num_reads(ref), rtol=1e-6)
    single = runs["port"]("p_se", runs["two"][6:], "--dumpEq")
    names, eq = merge_eq_dumps([os.path.join(o, "aux", "eq_classes.txt")
                                for o in (runs["plain"], single)])
    got_names, got = read_eq_classes(os.path.join(out, "aux",
                                                  "eq_classes.txt"))
    assert names == got_names
    assert (dict(zip(got.labels(), got.counts.tolist()))
            == dict(zip(eq.labels(), eq.counts.tolist())))
    assert _meta(out)["num_processed"] == 1200


def test_checkpoints_leave_the_result_alone(runs):
    """--checkpointInterval 128: after the first batches a resumable
    checkpoint is on disk (seen by stopping the run there), and the
    finished run equals the run without checkpoints."""
    import sailfish_tpu_torch.quant as pquant

    out = runs["port"]("p_ckpt", runs["paired"], "--dumpEq",
                       "--checkpointInterval", "128")
    assert _eq_text(out) == _eq_text(runs["plain"])
    assert (read_text(os.path.join(out, "quant.sf"))
            == read_text(os.path.join(runs["plain"], "quant.sf")))

    class Stop(Exception):
        pass

    seen = []

    def stopping(aux_path, names, eq, state):
        real(aux_path, names, eq, state)
        seen.append((state.num_observed, eq.total_count()))
        if len(seen) == 2:
            raise Stop

    real = pquant._write_checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pquant, "_write_checkpoint", stopping)
        with pytest.raises(Stop):
            runs["port"]("p_ckpt_cut", runs["paired"],
                         "--checkpointInterval", "128")
    assert [n for n, _ in seen] == [128, 256]
    cut = os.path.join(runs["dir"], "p_ckpt_cut")
    _, eq = read_eq_classes(os.path.join(cut, "aux", "eq_classes.txt"))
    assert eq.total_count() == seen[1][1] > 0
    resumed = runs["port"]("p_ckpt_resumed", ["-l", "IU"], "--resumeFromEq",
                           cut)
    assert _meta(resumed)["num_processed"] == 256


@pytest.mark.parametrize("flags,msg", [
    (["--numGibbsSamples", "2", "--numBootstraps", "2"],
     "cannot perform both Gibbs sampling and bootstrapping"),
    (["--biasCorrect", "--gcBiasCorrect"],
     "simultaneously is not supported"),
    (["--numShards", "2", "--shardId", "2"], "shard_id 2 out of range"),
])
def test_refused_combinations_carry_the_jax_messages(runs, capsys, flags,
                                                     msg):
    from sailfish_tpu_torch.cli import main as torch_main

    with pytest.raises(SystemExit) as ei:
        torch_main(["quant", "-i", runs["dir"], *runs["paired"], "-o",
                    os.path.join(runs["dir"], "refused"), "--device", "cpu",
                    *flags])
    assert ei.value.code == 2
    assert msg in capsys.readouterr().err
