"""The port's capacity-envelope tool (sailfish_tpu_torch/capacity_envelope.py)
against the JAX package's tools/capacity_envelope.py, loaded by path: the
repeat world and its mates bit for bit, repeat mode's JSON line at 64
fragments, probe mode on a small gene-family world probe by probe, the
drop sets that grow with the cap and equal the reference mapper's, and
the refusal to run on the CPU unless asked."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import sailfish_tpu.index.builder as jax_builder
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu_torch import bench, capacity_envelope as ce
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.io.fastq import FastqBatch
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.pipeline import RefMapperBackend

from torch_port import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAGS = 64
PROBE_TXPS, PROBE_FRAGS, PROBE_CAPS = 300, 40, [2, 4, 8]
REPEAT = ["--mode", "repeat", "--frags", str(FRAGS), "--device", "cpu"]
INDEX_FIELDS = ("codes", "sa", "packed16", "sep_dist", "table_lo",
                "txp_of_pos", "txp_offsets", "txp_lens")


def _load_tool(name, relpath, **consts):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in consts.items():
        setattr(mod, k, v)
    return mod


def _stdout_lines(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*a)
    return ret, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_repeat():
    """The JAX tool's repeat mode at CE_FRAGS=64: its JSON line, and the
    transcripts, index and mates it drew (captured around its calls of
    build_index and DeviceMapperBackend.map_pe_batch)."""
    tool = _load_tool("jax_capacity_envelope", "tools/capacity_envelope.py")
    seen = {}
    build, map_pe = jax_builder.build_index, JaxBackend.map_pe_batch

    def building(names, seqs, k=31, **kw):
        seen.update(names=list(names), seqs=[s.copy() for s in seqs], k=k)
        seen["index"] = build(names, seqs, k=k, **kw)
        return seen["index"]

    def mapping(self, b1, b2, expected):
        seen.setdefault("mates", tuple(
            a.copy() for a in (b1.codes, b1.lens, b2.codes, b2.lens)))
        return map_pe(self, b1, b2, expected)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CE_FRAGS", str(FRAGS))
        mp.setattr(jax_builder, "build_index", building)
        mp.setattr(JaxBackend, "map_pe_batch", mapping)
        _, lines = _stdout_lines(tool.main_repeat_device)
    return json.loads(lines[-1]), seen


@pytest.fixture(scope="module")
def port_repeat():
    """`--mode repeat --frags 64 --device cpu`: (its printed line, and
    what `run` returned: the line's dict, the world, the runs)."""
    ret, lines = _stdout_lines(ce.run, ce.parse_args(REPEAT))
    return json.loads(lines[-1]), ret


def test_repeat_line_equals_jax_tool(jax_repeat, port_repeat):
    """(a) Every key of the JAX tool's line, with its value; the extras
    say what was escalated and how wide the element's interval is."""
    want, _ = jax_repeat
    got, (doc, world, runs) = port_repeat
    assert got == doc
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"escalated_cap256", "escalated_cap2048",
                                    "element_interval", "device", "card"}
    assert got["dropped_at_256_kept_at_2048"] > 0
    assert got["escalated_cap256"] == got["escalated_cap2048"] > 0
    assert got["element_interval"] >= world.planted > 256
    assert got["device"] == got["card"] == "cpu"


def test_repeat_world_equals_jax_draws(jax_repeat, port_repeat):
    """(b) The transcripts and the mates are the JAX tool's bit for bit,
    and so is the k = 31 index."""
    _, seen = jax_repeat
    world = port_repeat[1][1]
    assert seen["k"] == 31
    assert seen["names"] == world.index.names
    assert len(seen["seqs"]) == len(world.seqs)
    for a, b in zip(world.seqs, seen["seqs"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    got = (world.b1.codes, world.b1.lens, world.b2.codes, world.b2.lens)
    for a, b in zip(got, seen["mates"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    idx = seen["index"]
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(world.index, f),
                                      getattr(idx, f), err_msg=f)
    assert world.index.kmer_ht.keys() == idx.kmer_ht.keys()


def test_drop_sets_grow_with_the_cap_and_equal_the_oracle(port_repeat):
    """(d) On the 64 repeat fragments: a fragment mapped at 256 is mapped
    at 2048, some are mapped only at 2048, and at each cap the port's eq
    classes and mapped flags equal the reference mapper's at the same
    --hitCapacityMax."""
    _, (_, world, runs) = port_repeat
    small, big = runs[256].result.mapped, runs[2048].result.mapped
    assert not (small & ~big).any() and (big & ~small).any()
    exp = parse_library_format("IU")
    bs = tuple(FastqBatch(b.codes[:, :b.lens[0]], b.lens)
               for b in (world.b1, world.b2))
    for cap, run in runs.items():
        ref = RefMapperBackend(world.index, QuantOpts(
            hit_capacity=64, hit_capacity_max=cap)).map_pe_batch(*bs, exp)
        br = run.result
        assert len(run.overflow) == run.escalated > 0, cap
        assert (dict(zip(br.labels, br.label_counts.tolist()))
                == dict(zip(ref.labels, ref.label_counts.tolist()))), cap
        assert np.array_equal(br.mapped, ref.mapped), cap


def test_probe_mode_matches_jax_tool(monkeypatch):
    """(c) Probe mode on a 300-transcript gene-family world at 40
    fragments and caps 2, 4, 8: the widest interval of every oriented
    mate the same, probe by probe, and the line the same in every key but
    `sec`."""
    gb = _load_tool("bench_gencode", "tools/bench_gencode.py",
                    TXPS=PROBE_TXPS, CACHE="")
    tool = _load_tool("jax_capacity_envelope_probe",
                      "tools/capacity_envelope.py", FRAGS=PROBE_FRAGS,
                      CAPS=PROBE_CAPS)
    monkeypatch.setitem(sys.modules, "bench_gencode", gb)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("GB_CACHE", "")

    def recording(cls, into):
        probe = cls.max_interval

        def max_interval(self, read):
            into.append(probe(self, read))
            return into[-1]

        monkeypatch.setattr(cls, "max_interval", max_interval)

    want_probes, got_probes = [], []
    recording(tool.ProbeSizeMapper, want_probes)
    recording(ce.ProbeSizeMapper, got_probes)
    _, jax_lines = _stdout_lines(tool.main)
    (doc, world, runs), lines = _stdout_lines(ce.run, ce.parse_args([
        "--frags", str(PROBE_FRAGS), "--txps", str(PROBE_TXPS), "--caps",
        ",".join(map(str, PROBE_CAPS)), "--cache", ""]))
    assert world is None and runs is None and lines == [json.dumps(doc)]
    assert len(got_probes) == 4 * PROBE_FRAGS
    assert got_probes == want_probes and max(got_probes) > PROBE_CAPS[0]
    want = json.loads(jax_lines[-1])
    assert list(doc) == list(want)
    del doc["sec"], want["sec"]
    assert doc == want


def test_defaults_and_world_flags():
    """The JAX tool's defaults per mode, the bench's world flags in probe
    mode, and repeat mode's fixed world."""
    probe = ce.parse_args([])
    assert (probe.mode, probe.frags, probe.caps) == ("probe", 5000,
                                                     [64, 256, 1024])
    assert (probe.txps, probe.bases, probe.index_dir, probe.cache) == (
        200_000, 150e6, None, bench.DEFAULT_CACHE)
    rep = ce.parse_args(["--mode", "repeat"])
    assert (rep.frags, rep.caps, rep.device) == (2048, [256, 2048], "cuda")
    got = ce.parse_args(["--txps", "7", "--index-dir", "x", "--cache", ""])
    assert (got.txps, got.index_dir, got.cache) == (7, "x", "")
    for bad in (["--mode", "repeat", "--txps", "7"],
                ["--mode", "repeat", "--cache", ""], ["--caps", "0,4"]):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(
                io.StringIO()):
            ce.parse_args(bad)


def test_repeat_defaults_to_the_card():
    """(e) Without --device cpu and without a card, repeat mode raises
    as_device's error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default runs")
    with pytest.raises(RuntimeError, match="is_available"):
        _stdout_lines(ce.main, ["--mode", "repeat", "--frags", "8"])
