"""The port's main path end to end against the JAX package on the toy
world: the mapping backend batch by batch (exact labels and counts,
including fragments remapped by the escalation pass), and the CLI
(`index` + `quant --dumpEq`) against sailfish_tpu.cli — identical
eq_classes.txt, equal EM iterations, equal Name/Length/EffectiveLength,
TPM and NumReads within rtol 1e-5 (quant.sf prints 6 significant
digits)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.eqclass.classes import HashedEqClassAccumulator
from sailfish_tpu.libformat import parse_library_format
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.eqclass.classes import (
    HashedEqClassAccumulator as PortAccumulator,
)
from sailfish_tpu_torch.libformat import (
    parse_library_format as port_format,
)
from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend

from conftest import to_batch
from torch_port import done_stats as _done_stats
from torch_port import port_batch, port_index
from torch_port import read_quant_sf as _read_quant_sf
from torch_port import write_world as _write_world
from torch_port import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def pidx(toy_world):
    return port_index(toy_world["idx"])


@pytest.mark.parametrize("cap,cap_max", [(16, 0), (2, 16)])
def test_backend_matches_jax(toy_world, pidx, cap, cap_max):
    """(2, 16): the shared 100bp segment overflows C = 2, so those
    fragments take the escalation pass at C = 16 in both packages."""
    kw = dict(batch_size=160, hit_capacity=cap, hit_capacity_max=cap_max)
    exp = parse_library_format("IU")
    pexp = port_format("IU")
    r1, r2, _ = toy_world["sim"](160, err_rate=0.3, seed=41)
    b1, b2 = to_batch(r1), to_batch(r2)
    pb1, pb2 = port_batch(b1), port_batch(b2)
    port = DeviceMapperBackend(pidx, QuantOpts(**kw), "cpu")
    ref = JaxBackend(toy_world["idx"], JaxOpts(**kw))
    bp = port.map_pe_batch(pb1, pb2, pexp)
    br = ref.map_pe_batch(b1, b2, exp)
    assert (dict(zip(bp.labels, bp.label_counts.tolist()))
            == dict(zip(br.labels, br.label_counts.tolist())))
    for f in ("mapped", "num_joint", "unique_paired", "frag_lens",
              "fmt_counts"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(br, f),
                                      err_msg=f)
    for f in ("num_fwd", "num_rc", "num_compat"):
        assert getattr(bp, f) == getattr(br, f), f

    # the hash-keyed fast path folds the same classes
    acc_p, acc_r = PortAccumulator(), HashedEqClassAccumulator()
    sp = port.finish_batch_fast(port.submit_pe(pb1, pb2, pexp), acc_p)
    tok_r = ref.submit_pe(b1, b2, exp)
    overflowed = int(np.asarray(tok_r[0]["scalars"])[72])
    sr = ref.finish_batch_fast(tok_r, acc_r)
    assert acc_p._counts == acc_r._counts
    assert (sp.num_mapped, sp.fld_count) == (sr.num_mapped, sr.fld_count)
    np.testing.assert_array_equal(sp.fld_hist(), sr.fld_hist())
    assert sp.num_escalated == (overflowed if cap_max else 0)
    assert (sp.num_escalated > 0) == bool(cap_max)


def test_cli_matches_jax_cli(toy_world, tmp_path, monkeypatch):
    from sailfish_tpu.cli import main as jax_main
    from sailfish_tpu_torch.cli import main as torch_main

    # no persistent jax compilation cache from inside the test process
    monkeypatch.setenv("SAILFISH_TPU_COMPILE_CACHE", "")
    fasta, (fq1, fq2) = _write_world(toy_world, str(tmp_path))
    outs = {}
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        idx = str(tmp_path / f"idx_{tag}")
        out = str(tmp_path / f"q_{tag}")
        assert main(["index", "-t", fasta, "-o", idx, "-k", "31"]) == 0
        dev = ["--device", "cpu"] if tag == "torch" else []
        assert main(["quant", "-i", idx, "-l", "IU", "-1", fq1, "-2", fq2,
                     "-o", out, "--dumpEq", "--batchSize", "128",
                     "--hitCapacity", "2", "--hitCapacityMax", "16",
                     *dev]) == 0
        outs[tag] = out
    ja, to = outs["jax"], outs["torch"]
    with open(os.path.join(ja, "aux", "eq_classes.txt")) as fh:
        eq_j = fh.read()
    with open(os.path.join(to, "aux", "eq_classes.txt")) as fh:
        eq_t = fh.read()
    assert eq_t == eq_j
    assert int(eq_t.split("\n")[1]) > 0
    sj, st = _done_stats(ja), _done_stats(to)
    assert st["em_iterations"] == sj["em_iterations"]
    assert st["num_mapped"] == sj["num_mapped"] > 0
    names_j, qj = _read_quant_sf(os.path.join(ja, "quant.sf"))
    names_t, qt = _read_quant_sf(os.path.join(to, "quant.sf"))
    assert names_t == names_j
    np.testing.assert_array_equal(qt[:, :2], qj[:, :2])
    np.testing.assert_allclose(qt[:, 2:], qj[:, 2:], rtol=1e-5, atol=0)
    assert abs(qt[:, 2].sum() - 1e6) < 1.0
    with open(os.path.join(to, "aux", "meta_info.json")) as fh:
        meta = json.load(fh)
    assert meta["quant_timings"]["device"] == "cpu"
    assert meta["quant_timings"]["escalated_fragments"] > 0
    for f in ("lib_format_counts.json", "aux/fld.gz", "cmd_info.json",
              "aux/quant_state.json"):
        assert os.path.exists(os.path.join(to, f)), f


def test_refimpl_backend_matches_device_backend(toy_world, pidx):
    """The host oracle behind `--backend refimpl` folds the same classes
    and FLD observations as the device backend (exact)."""
    from sailfish_tpu_torch.map.pipeline import make_backend

    opts = QuantOpts(hit_capacity=2, hit_capacity_max=16)
    exp = port_format("IU")
    r1, r2, _ = toy_world["sim"](96, err_rate=0.3, seed=43)
    b1, b2 = port_batch(to_batch(r1)), port_batch(to_batch(r2))
    stats, accs = {}, {}
    for name in ("device", "refimpl"):
        be = make_backend(pidx, opts, "cpu", name)
        accs[name] = be.accumulator()
        stats[name] = be.finish_batch_fast(be.submit_pe(b1, b2, exp),
                                           accs[name])
    d, r = stats["device"], stats["refimpl"]
    assert accs["refimpl"]._counts == accs["device"]._counts
    assert len(accs["refimpl"]._counts) > 0
    for f in ("n", "num_mapped", "sum_joint", "ub_hits", "num_fwd",
              "num_rc", "fld_count", "num_compat"):
        assert getattr(r, f) == getattr(d, f), f
    np.testing.assert_array_equal(r.fmt_counts, d.fmt_counts)
    np.testing.assert_array_equal(r.fld_hist(), d.fld_hist())


def test_cli_refimpl_backend_matches_device(toy_world, tmp_path):
    """`quant --backend refimpl` and the default device backend write the
    same eq_classes.txt and quant.sf (exact; EM runs on the same device
    over the same classes)."""
    from sailfish_tpu_torch.cli import main as torch_main

    fasta, (fq1, fq2) = _write_world(toy_world, str(tmp_path), n=200)
    idx = str(tmp_path / "idx")
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "31"]) == 0
    files = {}
    for backend in ("device", "refimpl"):
        out = str(tmp_path / f"q_{backend}")
        assert torch_main(["quant", "-i", idx, "-l", "IU", "-1", fq1, "-2",
                           fq2, "-o", out, "--dumpEq", "--backend", backend,
                           "--hitCapacity", "2", "--hitCapacityMax",
                           "16", "--device", "cpu"]) == 0
        with open(os.path.join(out, "aux", "meta_info.json")) as fh:
            assert json.load(fh)["quant_timings"]["backend"] == backend
        files[backend] = [open(os.path.join(out, f)).read()
                          for f in ("aux/eq_classes.txt", "quant.sf")]
    assert files["refimpl"] == files["device"]
    assert int(files["device"][0].split("\n")[1]) > 0


@pytest.mark.parametrize("argv", [
    ["--kernel", "pallas", "--scanShrink", "2"],
    ["--kernel", "xla2", "--scanShrink", "2"],
    ["--backend", "refimpl"],
], ids=["scanShrink", "scanShrink-xla2", "indexShards"])
def test_cli_refuses_flags_outside_slice(toy_world, tmp_path, argv):
    """What is still outside the port: the compacted scan under the JAX
    package's pallas and xla2 kernel choices, whose main pass that
    package leaves uncompacted; and, on an index built with `index
    --indexShards`, what the JAX package refuses there: the refimpl
    backend.  (The flags this list used to hold are quantified now:
    tests/test_torch_resume.py, the launcher form of --numShards,
    tests/test_torch_launcher.py, sharded indexes,
    tests/test_torch_shardidx.py, and --scanShrink under --kernel auto
    and xla, tests/test_torch_shrink.py.)"""
    from sailfish_tpu_torch.cli import main as torch_main

    _two_shards(toy_world, tmp_path)
    with pytest.raises(SystemExit) as ei:
        torch_main(["quant", "-i", str(tmp_path), "-l", "IU", "-1", "a.fq",
                    "-2", "b.fq", "-o", str(tmp_path / "o"), *argv])
    assert ei.value.code == 2


def _two_shards(toy_world, path):
    """A sharded index of two of the toy world's transcripts at `path`."""
    from sailfish_tpu_torch.index.builder import save_sharded_index
    from sailfish_tpu_torch.parallel.shardidx import sharded_index

    save_sharded_index(sharded_index(toy_world["names"][:2],
                                     toy_world["seqs"][:2], 2), str(path))


def test_cli_refuses_single_end_and_sharded_index(toy_world, tmp_path,
                                                  capsys):
    """A single-end libType without -r, a paired library with unequal
    file lists, and a bias flag on a sharded index are refused with a
    usage error (single-end libraries, second libraries and sharded
    indexes themselves are quantified: tests/test_torch_se.py,
    tests/test_torch_resume.py, tests/test_torch_shardidx.py)."""
    from sailfish_tpu_torch.cli import main as torch_main

    with pytest.raises(SystemExit) as ei:
        torch_main(["quant", "-i", str(tmp_path), "-l", "U", "-1", "a.fq",
                    "-2", "b.fq", "-o", str(tmp_path / "o")])
    assert ei.value.code == 2
    with pytest.raises(SystemExit) as ei:
        torch_main(["quant", "-i", str(tmp_path), "-l", "IU", "-1", "a.fq",
                    "-2", "b.fq", "-l", "IU", "-1", "c.fq", "d.fq", "-2",
                    "e.fq", "-o", str(tmp_path / "o")])
    assert ei.value.code == 2
    _two_shards(toy_world, tmp_path)
    capsys.readouterr()
    with pytest.raises(SystemExit) as ei:
        torch_main(["quant", "-i", str(tmp_path), "-l", "IU", "-1", "a.fq",
                    "-2", "b.fq", "-o", str(tmp_path / "o"),
                    "--gcBiasCorrect"])
    assert ei.value.code == 2
    assert "not available with a sharded index" in capsys.readouterr().err


def test_outside_slice_raises(toy_world, tmp_path):
    """The refimpl backend on a sharded index and option values the port
    does not know raise instead of switching paths; a 64-bit index and a
    sharded index directory load (reads over 128 bases map:
    tests/test_torch_xlong.py; 64-bit indexes map:
    tests/test_torch_bigsa.py; sharded ones: tests/test_torch_shardidx.py)."""
    import torch

    from sailfish_tpu.index.builder import build_index
    from sailfish_tpu_torch.index.builder import ShardedQuasiIndex, load_index
    from sailfish_tpu_torch.index.device import TorchIndex
    from sailfish_tpu_torch.map.pipeline import make_backend

    big = build_index(toy_world["names"][:2], toy_world["seqs"][:2], k=31,
                      force_big_sa=True)
    tidx = TorchIndex.from_quasi_index(port_index(big), "cpu")
    assert tidx.pos_bits == 64 and tidx.sa.dtype == torch.int64
    _two_shards(toy_world, tmp_path)
    sidx = load_index(str(tmp_path))
    assert isinstance(sidx, ShardedQuasiIndex) and sidx.num_shards == 2
    with pytest.raises(ValueError, match="device mesh only"):
        make_backend(sidx, QuantOpts(), "cpu", "refimpl")
    for bad in (dict(mmp_skip="hop"), dict(dtype="bfloat16"),
                dict(max_read_occs=-1), dict(hit_capacity=0)):
        with pytest.raises(ValueError):
            QuantOpts(**bad)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(toy_world, tmp_path):
    """Without --device cpu and without a card, `quant` fails with
    device.py as_device's message; it does not fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default runs")
    fasta, (fq1, fq2) = _write_world(toy_world, str(tmp_path), n=8)
    idx = str(tmp_path / "idx")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    cli = [sys.executable, "-m", "sailfish_tpu_torch.cli"]
    subprocess.run([*cli, "index", "-t", fasta, "-o", idx], env=env,
                   check=True, capture_output=True, timeout=300)
    proc = subprocess.run(
        [*cli, "quant", "-i", idx, "-l", "IU", "-1", fq1, "-2", fq2,
         "-o", str(tmp_path / "q")], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert not os.path.exists(tmp_path / "q" / "quant.sf")
