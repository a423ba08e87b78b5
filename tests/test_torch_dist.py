"""The port's data-parallel step (sailfish_tpu_torch/parallel/dist.py)
against the JAX package's (sailfish_tpu/parallel/dist.py), on the same
inputs made with numpy from a seed: its pieces one by one, then the
whole step at one rank (gloo, in this process) against `make_mesh(1)`
and at four gloo ranks spawned on the CPU against `make_mesh(4)` (the
conftest gives JAX 8 host devices), on both seed routes.  Alpha at
rtol 1e-5 (float32 sums in another order); the FLD, the mapped count and
both eq tables exactly."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import one_torch_thread, port_index  # noqa: F401  (autouse)

from sailfish_tpu.parallel import dist as jdist
from sailfish_tpu_torch.index.builder import build_index
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.parallel import dist as tdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import __graft_entry__ as ge  # noqa: E402

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 virtual JAX devices")

_OUTS = ("alpha", "fld", "num_mapped", "eq_counts", "eq_checksum")


def _labels(rng, B, W, T):
    """Label rows with PAD members behind label_len, singletons and
    empty rows."""
    label = np.full((B, W), -1, np.int32)
    label_len = rng.integers(0, W + 1, B).astype(np.int32)
    label_len[:6] = 1
    label_len[6:9] = 0
    for i in range(B):
        n = int(label_len[i])
        label[i, :n] = np.sort(rng.choice(T, n, replace=False))
    return label, label_len


def test_fragment_em_update_matches_jax():
    rng = np.random.default_rng(3)
    T, B, W = 24, 96, 8
    label, label_len = _labels(rng, B, W, T)
    eff = rng.uniform(0.0, 400.0, T).astype(np.float32)
    eff[[2, 5]] = 0.0                     # below 1: clamped to 1
    alpha = rng.uniform(0.0, 10.0, T).astype(np.float32)
    alpha[label[20, :label_len[20]]] = 0.0   # a fragment with denom 0
    alpha[[0, 7, 11]] = 0.0
    want = np.asarray(jdist._fragment_em_update(
        jnp.asarray(label), jnp.asarray(label_len), jnp.asarray(alpha),
        jnp.asarray(eff), T))
    got = tdist._fragment_em_update(
        torch.from_numpy(label), torch.from_numpy(label_len),
        torch.from_numpy(alpha), torch.from_numpy(eff), T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert label_len[20] > 1 and (label_len == 0).any()


def _hashes(rng, B):
    h1 = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    h1[: B // 4] = h1[B // 2: B // 2 + B // 4]   # repeated classes
    h2 = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    h2[: B // 4] = h2[B // 2: B // 2 + B // 4]
    mapped = rng.random(B) < 0.8
    h1[~mapped] = 0xFFFFFFFF                  # as merge_and_collapse marks
    h2[~mapped] = 0xFFFFFFFF
    return h1, h2, mapped


@pytest.mark.parametrize("bits", [16, 6])
def test_eq_hash_count_table_matches_jax(bits):
    """Random hashes, many of them colliding in a 2^6-slot table; the
    port takes them as int64 holding uint32."""
    h1, h2, mapped = _hashes(np.random.default_rng(bits), 4096)
    want = jdist.eq_hash_count_table(jnp.asarray(h1), jnp.asarray(h2),
                                     jnp.asarray(mapped), bits=bits)
    got = tdist.eq_hash_count_table(
        torch.from_numpy(h1.astype(np.int64)),
        torch.from_numpy(h2.astype(np.int64)), torch.from_numpy(mapped),
        bits=bits)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_expected_table_and_detector_match_jax():
    """expected_eq_table and collision_suspect_slots on random classes
    (counts large enough that the checksum wraps), and _wrap32."""
    rng = np.random.default_rng(9)
    h1 = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(1, 5000, 3000)
    for bits in (16, 8):
        for g, w in zip(tdist.expected_eq_table(h1, h2, counts, bits=bits),
                        jdist.expected_eq_table(h1, h2, counts, bits=bits)):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    ct, ck = tdist.expected_eq_table(h1, h2, counts, bits=8)
    rep = rng.integers(0, 2**32, len(ct)).astype(np.int64)
    rep[::3] = np.asarray(h2[:len(rep[::3])], np.int64)
    np.testing.assert_array_equal(tdist.collision_suspect_slots(ct, ck, rep),
                                  jdist.collision_suspect_slots(ct, ck, rep))
    x = rng.integers(-2**40, 2**40, 100)
    np.testing.assert_array_equal(tdist._wrap32(x), jdist._wrap32(x))


def test_eq_table_collision_detection():
    """tests/test_dist.py's forced collision through the port's copies:
    labels A x3 and B x2 share slot 0x42, C x4 sits alone in 0x99, one
    unmapped fragment counts nowhere; the detector fires on 0x42 only."""
    h1 = np.array([0x00010042] * 3 + [0x00020042] * 2 + [0x99] * 4
                  + [0xFFFFFFFF], np.int64)
    h2 = np.array([111] * 3 + [222] * 2 + [7] * 4 + [0xFFFFFFFF], np.int64)
    mapped = np.array([True] * 9 + [False])
    ct, ck = (t.numpy() for t in tdist.eq_hash_count_table(
        torch.from_numpy(h1), torch.from_numpy(h2), torch.from_numpy(mapped)))
    assert ct[0x42] == 5 and ct[0x99] == 4 and ct.sum() == 9
    assert ck[0x42] == 3 * 111 + 2 * 222 and ck[0x99] == 4 * 7
    ect, eck = tdist.expected_eq_table(
        np.array([0x00010042, 0x00020042, 0x99], np.uint32),
        np.array([111, 222, 7], np.uint32), np.array([3, 2, 4]))
    np.testing.assert_array_equal(ect, ct)
    np.testing.assert_array_equal(eck, ck)
    rep = np.zeros(len(ct), np.int64)
    rep[0x42] = 111
    rep[0x99] = 7
    assert tdist.collision_suspect_slots(ct, ck, rep).tolist() == [0x42]


def test_fld_histogram_matches_jnp_bincount():
    """Negative, zero and >= max_frag_len lengths, unique-paired or not:
    the JAX step's bincount (a negative value counts in bin 0)."""
    rng = np.random.default_rng(4)
    max_fl = 50
    fl = rng.integers(-20, 80, 2000).astype(np.int32)
    fl[:5] = [-3, 0, 1, max_fl - 1, max_fl]
    up = rng.random(2000) < 0.7
    up[:5] = True
    j = jnp.where(jnp.asarray(up) & (jnp.asarray(fl) < max_fl),
                  jnp.asarray(fl), max_fl)
    want = np.asarray(jnp.bincount(j, length=max_fl + 1)[:max_fl])
    got = tdist.fld_histogram(torch.from_numpy(fl), torch.from_numpy(up),
                              max_fl)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] > 0


@pytest.fixture(scope="module")
def step_world():
    """tests/test_dist.py's world: 12 transcripts, 64 fragments, through
    the JAX step (memoized by mesh size and route)."""
    from sailfish_tpu.config import QuantOpts
    from sailfish_tpu.map.pipeline import DeviceMapperBackend

    idx, seqs = ge._synthetic_world(num_txps=12, txp_len=300, seed=5)
    backend = DeviceMapperBackend(idx, QuantOpts())
    eff = np.maximum(idx.txp_lens.astype(np.float64) - 150.0,
                     1.0).astype(np.float32)
    c1, c2, lens = ge._sim_pe(seqs, 64, seed=6)
    alpha0 = np.full(idx.num_transcripts, 1.0, np.float32)
    cache = {}

    def kw(use_hash):
        return dict(k=idx.k, prefix_bases=idx.prefix_bases, cand_cap=16,
                    max_mmps=2, max_steps=4, use_hash=use_hash,
                    ht_probes=backend.ht_probes if use_hash else 0,
                    ht_bits=backend.ht_bits if use_hash else 0)

    def jax_step(n, use_hash):
        if (n, use_hash) not in cache:
            step = jdist.distributed_quant_step(
                jdist.make_mesh(n), backend.text, jnp.asarray(eff),
                **kw(use_hash))
            out = step(jnp.asarray(c1), jnp.asarray(lens), jnp.asarray(c2),
                       jnp.asarray(lens), jnp.asarray(alpha0))
            cache[n, use_hash] = dict(zip(_OUTS, map(np.asarray, out)))
        return cache[n, use_hash]

    return dict(index=port_index(idx), eff=eff, batch=(c1, lens, c2, lens),
                alpha=alpha0, kw=kw, jax_step=jax_step)


def _same_as_jax(got, want):
    assert got["alpha"].dtype == np.float32
    np.testing.assert_allclose(got["alpha"], want["alpha"], rtol=1e-5)
    np.testing.assert_array_equal(got["fld"], want["fld"])
    assert got["num_mapped"] == int(want["num_mapped"]) > 0
    np.testing.assert_array_equal(got["eq_counts"], want["eq_counts"])
    np.testing.assert_array_equal(got["eq_checksum"], want["eq_checksum"])
    assert got["eq_counts"].dtype == got["eq_checksum"].dtype == np.int32
    assert int(got["eq_counts"].sum()) == got["num_mapped"]


@pytest.mark.parametrize("use_hash", [True, False], ids=["hash", "prefix"])
def test_step_one_rank_matches_jax(step_world, use_hash):
    """One gloo rank in this process (its own process group, started and
    destroyed here) against the JAX step on make_mesh(1)."""
    w = step_world
    mesh = tdist.make_mesh(1, device="cpu")
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        got = tdist.run_step(mesh, w["index"], w["eff"], w["batch"],
                             w["alpha"], w["kw"](use_hash))
    finally:
        mesh.close()
    _same_as_jax(got, w["jax_step"](1, use_hash))


def test_step_mates_of_two_widths(step_world):
    """Mates of two widths: the step pads the narrower with code 4 into
    one lane block (the JAX step maps each mate in a block of its own);
    read 2 widened by 8 columns of code 4 gives the outputs of the run
    at equal widths."""
    w = step_world
    c1, lens, c2, _ = w["batch"]
    wide = np.full((c2.shape[0], c2.shape[1] + 8), 4, np.uint8)
    wide[:, :c2.shape[1]] = c2
    mesh = tdist.make_mesh(1, device="cpu")
    try:
        got = [tdist.run_step(mesh, w["index"], w["eff"], (c1, lens, m, lens),
                              w["alpha"], w["kw"](True)) for m in (c2, wide)]
    finally:
        mesh.close()
    for key in _OUTS:
        np.testing.assert_array_equal(got[0][key], got[1][key])


@pytest.mark.parametrize("use_hash", [True, False], ids=["hash", "prefix"])
def test_step_four_ranks_match_jax(step_world, use_hash):
    """Four gloo ranks spawned on the CPU, each mapping its 16 rows,
    against the JAX step on make_mesh(4); every rank returns the same
    merged outputs."""
    w = step_world
    results = tdist.spawn(tdist.run_step, 4, w["index"], w["eff"],
                          w["batch"], w["alpha"], w["kw"](use_hash),
                          device="cpu", threads=1, timeout=300)
    _same_as_jax(tdist.same_on_every_rank(results), w["jax_step"](4, use_hash))


def test_step_refuses_what_jax_refuses(step_world):
    """A batch that does not split over the ranks; a k, prefix_bases,
    ht_bits or ht_probes other than the index's; use_hash on an index
    without a k-mer table; a TorchIndex of the other route."""
    w = step_world
    index, kw = w["index"], w["kw"](True)
    two = tdist.Mesh(rank=0, size=2, device=torch.device("cpu"), group=None,
                     backend="gloo")
    step = tdist.distributed_quant_step(two, index, w["eff"], **kw)
    c1, lens, c2, _ = w["batch"]
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        step(c1[:63], lens[:63], c2[:63], lens[:63], w["alpha"])
    for key, bad in (("k", 29), ("prefix_bases", kw["prefix_bases"] + 1),
                     ("ht_bits", kw["ht_bits"] + 1),
                     ("ht_probes", kw["ht_probes"] + 1)):
        with pytest.raises(ValueError, match=f"{key}={bad} but the index"):
            tdist.distributed_quant_step(two, index, w["eff"],
                                         **{**kw, key: bad})
    rng = np.random.default_rng(0)
    small = build_index(["a", "b"], [rng.integers(0, 4, 200).astype(np.uint8)
                                     for _ in range(2)], k=15)
    with pytest.raises(ValueError, match="needs an index with a k-mer"):
        tdist.distributed_quant_step(
            two, small, np.ones(2, np.float32), k=15,
            prefix_bases=small.prefix_bases, use_hash=True)
    tidx = TorchIndex.from_quasi_index(index, "cpu")
    with pytest.raises(ValueError, match="has a k-mer table"):
        tdist.distributed_quant_step(two, tidx, w["eff"],
                                     **w["kw"](False))


def test_make_mesh_refuses_more_nccl_ranks_than_cards(monkeypatch):
    """NCCL ranks need distinct cards: two ranks on a host of one card
    are refused before any process group starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tdist.make_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="NCCL needs cuda"):
        tdist.make_mesh(1, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


def _entry(*argv):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "sailfish_tpu_torch.parallel.dist", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cuda_without_a_card_is_refused():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA device")
    with pytest.raises(RuntimeError, match="is_available"):
        tdist.make_mesh(1, device="cuda")
    proc = _entry("--world", "1")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert proc.stdout == ""


def test_entry_point_four_cpu_ranks():
    """`python -m sailfish_tpu_torch.parallel.dist --world 4 --device
    cpu`: the dryrun's checks pass and it prints its JSON line."""
    proc = _entry("--world", "4", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (line["world"], line["backend"], line["device"]) == (4, "gloo",
                                                              "cpu")
    assert line["n_mapped"] == line["fragments"] == 256
    assert line["classes"] > 0 and line["step_ms"] > 0
    assert abs(line["alpha_sum"] - line["n_mapped"]) < 1e-2 * 256
