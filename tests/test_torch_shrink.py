"""`--scanShrink N`, the compacted scan of the JAX package's XLA kernel
(map/kernels.py `map_oriented_lanes(scan_shrink=N)`), through the port's
step stamps (map/scan.py) and cut pass (map/shrink.py), on the toy world:
the lane mapper against the XLA kernel exactly, the stamps' invariants,
N <= 1 as no compaction, `quant` through both CLIs, and the paths that
ignore the option.  A compacted XLA call compiles one step at a time
(about 0.4 s a step on the CPU), so the JAX calls are shared and their
step budgets short where a case does not need the full one."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import dna
from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.index.builder import build_index
from sailfish_tpu.map.encode import make_oriented_lanes as jax_lanes
from sailfish_tpu.map.kernels import map_oriented_lanes as jax_map
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.map.encode import make_oriented_lanes
from sailfish_tpu_torch.map.lanes import map_oriented_lanes
from sailfish_tpu_torch.map.scan import mmp_scan, mmp_scan_reference
from sailfish_tpu_torch.map.shrink import apply_cut
from sailfish_tpu_torch.parallel import dist as tdist

from test_torch_scan import _assert_same
from torch_port import (
    assert_same_quant,
    port_index,
    read_text,
    run_both_clis,
    write_fasta,
    write_fastq,
)
from torch_port import one_torch_thread  # noqa: F401  (autouse)

C, M = 16, 4
ERR = 0.03      # substitutions a base: reads that need many steps


def _reads(seqs, n, rl, seed):
    """n reads of rl bases (half of them reverse complemented) with ERR
    substitutions a base, padded to a multiple of 8 with code 4."""
    rng = np.random.default_rng(seed)
    L = (rl + 7) // 8 * 8
    codes = np.full((n, L), 4, np.uint8)
    for i in range(n):
        s = seqs[int(rng.integers(0, len(seqs)))]
        p = int(rng.integers(0, len(s) - rl))
        m = s[p:p + rl].copy()
        if i % 2:
            m = dna.revcomp(m).copy()
        e = rng.random(rl) < ERR
        m[e] = (m[e] + rng.integers(1, 4, int(e.sum()))) % 4
        codes[i, :rl] = m
    return codes, np.full(n, rl, np.int32)


@pytest.fixture(scope="module")
def worlds(toy_world):
    """route -> (JAX index, the XLA kernel's text, the port's CPU index):
    the k = 31 index (k-mer route) and a k = 15 index (prefix route)."""
    out = {}
    for route, idx in (("kmer", toy_world["idx"]),
                       ("prefix", build_index(toy_world["names"],
                                              toy_world["seqs"], k=15))):
        out[route] = (idx, JaxBackend(idx, JaxOpts()),
                      TorchIndex.from_quasi_index(port_index(idx), "cpu"))
    return out


@pytest.fixture(scope="module")
def lane_reads(toy_world):
    """512 reads of 40 bases: 1,024 oriented lanes, so that the widths
    1,024 -> 512 -> ... -> 64 cut lanes that are still scanning."""
    return _reads(toy_world["seqs"], 512, 40, seed=11)


def _port(tidx, codes, lens, **kw):
    out = map_oriented_lanes(tidx, torch.from_numpy(codes),
                             torch.from_numpy(lens), **kw)
    return {k: v.numpy() for k, v in out.items()}


# (route, N, skip rule, max_steps; None = the full budget)
LANE_CASES = [("kmer", 2, "nip", None), ("kmer", 4, "jump", 8),
              ("prefix", 2, "nip", 8)]


@pytest.mark.parametrize(
    "route,shrink,skip,steps", LANE_CASES,
    ids=["-".join(str(x) for x in c) for c in LANE_CASES])
def test_lane_mapper_matches_xla_kernel(worlds, lane_reads, route, shrink,
                                        skip, steps):
    """Every field of the port's compacted map equals the XLA kernel's
    (txp and pos at the valid slots), and the compaction cut hits: fewer
    valid slots than the uncompacted map's."""
    idx, be, tidx = worlds[route]
    codes, lens = lane_reads
    kw = dict(cand_cap=C, max_mmps=M, max_steps=steps or codes.shape[1],
              skip_jump=(skip == "jump"))
    lanes = jax_lanes(jnp.asarray(codes), jnp.asarray(lens),
                      idx.prefix_bases)
    ref = jax_map(be.text, lanes, k=idx.k, prefix_bases=idx.prefix_bases,
                  use_hash=(route == "kmer"),
                  ht_probes=be.ht_probes if route == "kmer" else 0,
                  ht_bits=be.ht_bits if route == "kmer" else 0,
                  scan_shrink=shrink, **kw)
    got = _port(tidx, codes, lens, scan_shrink=shrink, **kw)
    _assert_same(got, ref)
    whole = _port(tidx, codes, lens, **kw)
    assert 0 < got["valid"].sum() < whole["valid"].sum()


def _scan(tidx, codes, lens, **kw):
    lanes = make_oriented_lanes(torch.from_numpy(codes),
                                torch.from_numpy(lens))
    return mmp_scan_reference(lanes, tidx, cand_cap=kw.pop("cand_cap", C),
                              max_mmps=M, **kw)


@pytest.mark.parametrize("route,cap", [("kmer", C), ("kmer", 2),
                                       ("prefix", C)])
def test_stamps_of_the_plain_version(worlds, lane_reads, route, cap):
    """Stamps rise across the recorded slots, lie below the lane's step
    count and number exactly nm; slot M is set exactly on the overflowed
    lanes.  The other outputs are those of the scan without stamps, and
    cutting every lane at step s gives the scan of max_steps = s
    exactly: the truncated scan is what a compaction leaves a stopped
    lane."""
    _, _, tidx = worlds[route]
    codes, lens = lane_reads
    L = codes.shape[1]
    txp, pos, vld, meta, st = _scan(tidx, codes, lens, cand_cap=cap,
                                    max_steps=L, stamps=True)
    assert st.dtype == torch.int32 and st.shape == (2 * len(lens), M + 1)
    for a, b in zip((txp, pos, vld, meta),
                    _scan(tidx, codes, lens, cand_cap=cap, max_steps=L)):
        assert torch.equal(a, b)
    s = st.long()
    nm, steps = meta[:, 0].long(), meta[:, 3].long()
    rec = s[:, :M] >= 0
    assert torch.equal(rec.sum(1), nm)
    assert torch.equal(rec, torch.arange(M)[None, :] < nm[:, None])
    assert bool(((s[:, 1:M] > s[:, :M - 1]) | ~rec[:, 1:]).all())
    assert bool(((s[:, :M] < steps[:, None]) | ~rec).all())
    assert torch.equal(s[:, M] >= 0, meta[:, 1] != 0)
    assert bool(((s[:, M] < steps) | (s[:, M] < 0)).all())
    if cap == 2:
        assert bool((meta[:, 1] != 0).any())
    for cut in (1, 2, 5, 9):
        want = _scan(tidx, codes, lens, cand_cap=cap, max_steps=cut)
        end = torch.clamp(steps, max=cut)
        got = apply_cut(txp, pos, vld, meta, st, end, C=cap, M=M)
        for a, b in zip(got, want):
            assert torch.equal(a, b), cut


@pytest.mark.parametrize("shrink", [0, 1])
def test_shrink_up_to_one_is_no_compaction(worlds, lane_reads, shrink):
    """N = 0 and N = 1 give today's map, every field, raw."""
    _, _, tidx = worlds["kmer"]
    codes, lens = lane_reads
    kw = dict(cand_cap=C, max_mmps=M, max_steps=codes.shape[1])
    want = _port(tidx, codes, lens, **kw)
    got = _port(tidx, codes, lens, scan_shrink=shrink, pad_lanes=64, **kw)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_scan_dispatch_returns_stamps_on_the_cpu(worlds, lane_reads):
    """`mmp_scan` takes `stamps=` as the kernel's wrapper does: on a CPU
    tensor it runs the plain version and returns the stamps fifth."""
    _, _, tidx = worlds["kmer"]
    codes, lens = lane_reads
    lanes = make_oriented_lanes(torch.from_numpy(codes),
                                torch.from_numpy(lens))
    kw = dict(cand_cap=C, max_mmps=M, max_steps=12)
    got = mmp_scan(lanes, tidx, stamps=True, **kw)
    want = mmp_scan_reference(lanes, tidx, stamps=True, **kw)
    assert len(got) == 5
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _fragments(toy_world, d, n, rl, seed, shared=0.0):
    """FASTA and the two mate files of n fragments with ERR substitutions
    a base, in directory d; returns (fasta, [r1, r2]).  Every 4th
    fragment's mate 2 also has a substitution at its last base: its
    reverse complement, the lane that maps, misses at position 0 and
    needs step 1, which a compaction cuts when the lane ranks behind the
    width (at rl = 32 the reads have 2 positions, and only such lanes
    show the compaction).  A `shared` share of the fragments starts in
    the 100 bases that transcripts 0, 3 and 6 share at 50: their mate 1
    has 3 copies of each k-mer, which --hitCapacity 2 overflows."""
    rng = np.random.default_rng(seed)
    seqs = toy_world["seqs"]
    mates = ([], [])
    for _ in range(n):
        if rng.random() < shared:
            s = seqs[3 * int(rng.integers(0, 3))]
            fl = int(rng.integers(2 * rl, 301))
            p = int(rng.integers(50, 150 - rl + 1))
        else:
            s = seqs[int(rng.integers(0, len(seqs)))]
            fl = int(rng.integers(2 * rl, min(300, len(s)) + 1))
            p = int(rng.integers(0, len(s) - fl + 1))
        frag = s[p:p + fl]
        m2 = dna.revcomp(frag[-rl:]).copy()
        if len(mates[1]) % 4 == 0:
            m2[-1] = (m2[-1] + 1) % 4
        for out, m in ((mates[0], frag[:rl].copy()), (mates[1], m2)):
            e = rng.random(rl) < ERR
            m[e] = (m[e] + rng.integers(1, 4, int(e.sum()))) % 4
            out.append(m)
    fasta = write_fasta(os.path.join(d, "txps.fa"), toy_world["names"], seqs)
    return fasta, [write_fastq(os.path.join(d, f"r{i}.fq"), r, f"/{i}")
                   for i, r in ((1, mates[0]), (2, mates[1]))]


def _quant_port(idx, fq, out, *flags):
    from sailfish_tpu_torch.cli import main as torch_main

    assert torch_main(["quant", "-i", idx, "-l", "IU", "-1", fq[0], "-2",
                       fq[1], "-o", out, "--dumpEq", "--device", "cpu",
                       *flags]) == 0
    return [read_text(os.path.join(out, f))
            for f in ("aux/eq_classes.txt", "quant.sf")]


# (fragments, their share in the shared segment, flags beside
# --scanShrink 2 --batchSize 256), reads of 32 bases: 600 fragments end
# in a batch of 88, whose 352 lanes the JAX package pads to 1,024 (a
# first width of 352 would cut their mates 2); at --hitCapacity 2 the
# shared segment's fragments escalate, over 100 a batch, and the
# escalation chunk's lanes are padded to 4 x 1,024 (their own count
# would cut)
CLI_CASES = {"partial_batch": (600, 0.0, ()),
             "escalation": (512, 0.5, ("--hitCapacity", "2",
                                       "--hitCapacityMax", "16"))}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_quant_matches_jax_cli(toy_world, tmp_path, monkeypatch, case):
    """`quant --scanShrink 2 --batchSize 256` through both CLIs: eq
    classes and quant.sf equal; the port's --scanShrink 0 and 1 give its
    run without the flag, which differs from the compacted one."""
    from sailfish_tpu_torch.cli import main as torch_main

    n, shared, flags = CLI_CASES[case]
    d = str(tmp_path)
    fasta, fq = _fragments(toy_world, d, n, 32, seed=5, shared=shared)
    idx = os.path.join(d, "idx")
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "31"]) == 0
    outs, got = run_both_clis(
        monkeypatch, idx, d, "IU", ["-1", fq[0], "-2", fq[1]],
        ["--scanShrink", "2", "--batchSize", "256", *flags])
    assert_same_quant(outs, got)
    assert got["torch"]["num_observed"] == n
    assert (got["torch"]["num_escalated"] > 0) == (case == "escalation")
    if case == "partial_batch":
        plain = _quant_port(idx, fq, os.path.join(d, "n1"), "--batchSize",
                            "256", *flags)
        assert _quant_port(idx, fq, os.path.join(d, "n0"), "--batchSize",
                           "256", "--scanShrink", "0", *flags) == plain
        assert read_text(os.path.join(outs["torch"], "aux",
                                      "eq_classes.txt")) != plain[0]


def test_sharded_index_ignores_the_option(toy_world, tmp_path):
    """On an index in 2 shards, as on the JAX package's sharded backend,
    --scanShrink changes nothing."""
    from sailfish_tpu_torch.cli import main as torch_main

    d = str(tmp_path)
    fasta, fq = _fragments(toy_world, d, 300, 50, seed=7)
    idx = os.path.join(d, "idx2")
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "31",
                       "--indexShards", "2"]) == 0
    flags = ("--batchSize", "256")
    want = _quant_port(idx, fq, os.path.join(d, "q1"), *flags)
    assert _quant_port(idx, fq, os.path.join(d, "q2"), *flags,
                       "--scanShrink", "4") == want
    assert int(want[0].split("\n")[1]) > 0


def test_dist_step_ignores_the_option():
    """The data-parallel step maps as the JAX step does, uncompacted,
    whatever its options' scan_shrink."""
    idx, seqs = tdist._synthetic_world(num_txps=12, txp_len=300, seed=5)
    c1, c2, lens = tdist._sim_pe(seqs, 64, seed=6)
    rng = np.random.default_rng(6)
    for c in (c1, c2):
        e = rng.random((64, 50)) < ERR
        c[:, :50][e] = (c[:, :50][e] + 1) % 4
    eff = np.maximum(idx.txp_lens - 150.0, 1.0).astype(np.float32)
    alpha = np.full(idx.num_transcripts, 1.0, np.float32)
    tidx = TorchIndex.from_quasi_index(idx, "cpu")
    kw = dict(k=idx.k, prefix_bases=idx.prefix_bases, cand_cap=16,
              max_mmps=2, max_steps=12, use_hash=True,
              ht_probes=tidx.ht_probes, ht_bits=tidx.ht_bits)
    got = []
    mesh = tdist.make_mesh(1, device="cpu")
    try:
        for shrink in (1, 4):
            got.append(tdist.run_step(
                mesh, idx, eff, (c1, lens, c2, lens), alpha,
                {**kw, "opts": QuantOpts(scan_shrink=shrink)}))
    finally:
        mesh.close()
    assert got[0]["num_mapped"] > 0
    # the same rows compacted by the lane mapper: the option would show
    codes = torch.from_numpy(np.concatenate([c1, c2]))
    ll = torch.from_numpy(np.concatenate([lens, lens]))
    lane_kw = dict(cand_cap=16, max_mmps=2, max_steps=12, skip_jump=True)
    assert not torch.equal(
        map_oriented_lanes(tidx, codes, ll, scan_shrink=4,
                           **lane_kw)["valid"],
        map_oriented_lanes(tidx, codes, ll, **lane_kw)["valid"])
    for key in ("alpha", "fld", "num_mapped", "eq_counts", "eq_checksum"):
        np.testing.assert_array_equal(got[1][key], got[0][key])
