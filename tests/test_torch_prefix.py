"""The port's prefix-table route (indexes with k < 17, which have no
k-mer table) against the JAX package's XLA kernel
(map/kernels.py `map_oriented_lanes(use_hash=False)`; the Pallas kernel
takes no such index), at k = 13 and k = 15 on the toy world, and the
port's CLI on a k = 15 index against the JAX CLI.  Every map comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.config import QuantOpts
from sailfish_tpu.index.builder import build_index
from sailfish_tpu.map.encode import make_oriented_lanes as jax_lanes
from sailfish_tpu.map.kernels import map_oriented_lanes as jax_map
from sailfish_tpu.map.pipeline import DeviceMapperBackend
from sailfish_tpu_torch.index.builder import QuasiIndex
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.map.encode import make_oriented_lanes
from sailfish_tpu_torch.map.lanes import map_oriented_lanes
from sailfish_tpu_torch.map.scan import (
    mmp_scan,
    mmp_scan_cuda,
    mmp_scan_reference,
)

from test_torch_scan import _assert_same, _reads
from torch_port import assert_same_quant, port_index, risk_reads, run_both_clis
from torch_port import write_world
from torch_port import one_torch_thread  # noqa: F401  (autouse)

RISK_L = 104


@pytest.fixture(scope="module")
def prefix_worlds(toy_world):
    """k -> (JAX index of the toy world without a k-mer table, the XLA
    kernel's text arrays, the port's index on the CPU)."""
    out = {}
    for k in (13, 15):
        idx = build_index(toy_world["names"], toy_world["seqs"], k=k)
        assert idx.kmer_ht is None
        out[k] = (idx, DeviceMapperBackend(idx, QuantOpts()).text,
                  TorchIndex.from_quasi_index(port_index(idx), "cpu"))
    return out


def _xla(text, idx, codes, lens, **kw):
    lanes = jax_lanes(jnp.asarray(codes), jnp.asarray(lens),
                      idx.prefix_bases)
    return jax_map(text, lanes, k=idx.k, prefix_bases=idx.prefix_bases,
                   use_hash=False, **kw)


def _port(tidx, codes, lens, **kw):
    out = map_oriented_lanes(tidx, torch.from_numpy(codes),
                             torch.from_numpy(lens), **kw)
    return {k: v.numpy() for k, v in out.items()}


# (reads, max_steps, skip rule, candidate capacity) as test_torch_scan's
# CASES; max_steps None = the full budget
CASES = [
    ("toy", None, "jump", 16),
    ("toy", None, "nip", 2),
    ("risk", 1, "nip", 16),
    ("risk", None, "nip", 16),
    ("risk", None, "jump", 16),
    ("risk", 33, "nip", 2),
]


@pytest.mark.parametrize("k", [13, 15])
@pytest.mark.parametrize(
    "reads,steps,skip,cap", CASES,
    ids=["-".join(str(x) for x in c) for c in CASES])
def test_prefix_route_matches_xla_kernel(toy_world, prefix_worlds, k, reads,
                                         steps, skip, cap):
    idx, text, tidx = prefix_worlds[k]
    assert tidx.prefix_route and tidx.ht is None
    if reads == "toy":
        codes, lens = _reads(toy_world)
    else:
        codes, lens = risk_reads(toy_world["seqs"], k, RISK_L, seed=23)
    kw = dict(cand_cap=cap, max_mmps=4, max_steps=steps or codes.shape[1],
              skip_jump=(skip == "jump"))
    port = _port(tidx, codes, lens, **kw)
    _assert_same(port, _xla(text, idx, codes, lens, **kw))
    assert port["valid"].any()
    if cap == 2 and steps is None:
        assert port["overflow"].any()


def test_empty_refinement_leaves_the_coarse_interval(toy_world,
                                                     prefix_worlds):
    """Trap 3: at k = 15 an empty depth-0 refinement proves nothing (its
    16 bases cover more than k), so the coarse interval of P = 4 bases
    stands and overflows a capacity below it; with the same reads on a
    prefix-route index of k = 31 the empty refinement proves a miss, and
    nothing overflows.  Reads: random bases, whose 16-mers the text does
    not hold."""
    idx, text, tidx = prefix_worlds[15]
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, (16, 56)).astype(np.uint8)
    lens = np.full(16, 56, np.int32)
    kw = dict(cand_cap=4, max_mmps=4, max_steps=56)
    port = _port(tidx, codes, lens, **kw)
    _assert_same(port, _xla(text, idx, codes, lens, **kw))
    assert port["overflow"].all() and not port["valid"].any()
    # the same text as a prefix-route index of k = 31
    big = QuasiIndex.from_arrays(
        k=31, names=idx.names, codes=idx.codes, sa=idx.sa,
        txp_of_pos=idx.txp_of_pos, txp_offsets=idx.txp_offsets,
        txp_lens=idx.txp_lens, kmer_ht=None, prefix_bases=idx.prefix_bases)
    port31 = _port(TorchIndex.from_quasi_index(big, "cpu"), codes, lens,
                   **kw)
    lanes = jax_lanes(jnp.asarray(codes), jnp.asarray(lens),
                      idx.prefix_bases)
    ref31 = jax_map(text, lanes, k=31, prefix_bases=idx.prefix_bases,
                    use_hash=False, **kw)
    _assert_same(port31, ref31)
    assert not port31["overflow"].any()


def test_n_in_the_prefix_gives_no_seed(toy_world, prefix_worlds):
    """Trap 1: a position whose first P bases hold an N has no seed (the
    k-mer route would hash the N as an A): reads cut from the text with
    an N at base 2, P - 1 and P, under both skip rules, against the XLA
    kernel; the reads still map from behind the N."""
    idx, text, tidx = prefix_worlds[13]
    P = idx.prefix_bases
    rng = np.random.default_rng(37)
    seqs = toy_world["seqs"]
    codes = np.full((24, 56), 4, np.uint8)
    for r in range(24):
        s = seqs[r % len(seqs)]
        p = int(rng.integers(0, len(s) - 50))
        codes[r, :50] = s[p:p + 50]
        codes[r, (2, P - 1, P)[r % 3]] = 4
    lens = np.full(24, 50, np.int32)
    for skip in (False, True):
        kw = dict(cand_cap=16, max_mmps=4, max_steps=56, skip_jump=skip)
        port = _port(tidx, codes, lens, **kw)
        _assert_same(port, _xla(text, idx, codes, lens, **kw))
        assert port["valid"][:24].any(axis=1).all()


def test_dispatch_and_work_of_the_prefix_route(toy_world, prefix_worlds):
    """On CPU tensors `mmp_scan` is the plain version, bit for bit, and
    launches no kernel (on either route's count); the CUDA wrapper
    refuses CPU tensors.  `work` counts the prefix route's reads: a
    lookup per probed position with a clean prefix, up to 2 x 26 search
    steps per refinement, one to ceil(50 / 16) text chunks a candidate.
    A k >= 17 index carries no prefix arrays."""
    idx, _, tidx = prefix_worlds[15]
    codes, lens = _reads(toy_world, seed=5)
    lanes = make_oriented_lanes(torch.from_numpy(codes),
                                torch.from_numpy(lens))
    kw = dict(cand_cap=16, max_mmps=4, max_steps=codes.shape[1])
    before = (mmp_scan_cuda.launches, mmp_scan_cuda.prefix_launches)
    work = {}
    a = mmp_scan(lanes, tidx, **kw)
    b = mmp_scan_reference(lanes, tidx, work=work, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (mmp_scan_cuda.launches, mmp_scan_cuda.prefix_launches) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mmp_scan_cuda(lanes, tidx, **kw)
    assert set(work) == {"lookups", "search_steps", "candidates",
                         "text_bytes", "stored", "seeds", "chunks"}
    steps = int(a[3][:, 3].sum())
    assert 0 < work["lookups"] <= steps
    assert 0 < work["search_steps"] <= 4 * 26 * work["lookups"]
    assert work["candidates"] <= 16 * work["seeds"]
    assert work["stored"] >= int(a[2].sum()) > 0
    assert work["candidates"] <= work["chunks"] <= 4 * work["candidates"]
    assert tidx.packed.shape == (len(idx.codes) + 512,)
    assert tidx.table_lo.shape == (4 ** idx.prefix_bases + 1,)
    k31 = TorchIndex.from_quasi_index(port_index(toy_world["idx"]), "cpu")
    assert k31.table_lo is None and k31.packed is None and k31.ht is not None


def test_cli_quant_on_a_k15_index_matches_jax_cli(toy_world, tmp_path,
                                                  monkeypatch):
    """`index -k 15` then `quant --dumpEq` of the port (--device cpu)
    against the JAX CLI (--kernel xla, the prefix route) on the same
    index directory: identical eq_classes.txt and quant_state.json,
    quant.sf within the tolerance of tests/test_torch_quant.py.  The JAX
    CLI quantifies the port-built directory."""
    from sailfish_tpu_torch.cli import main as torch_main

    fasta, (fq1, fq2) = write_world(toy_world, str(tmp_path), n=300)
    idx = str(tmp_path / "idx15")
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "15"]) == 0
    outs, got = run_both_clis(monkeypatch, idx, str(tmp_path), "IU",
                              ["-1", fq1, "-2", fq2])
    assert_same_quant(outs, got)


def test_sf_prints_the_jax_cli_logo(capsys):
    """`sf`, the one subcommand the port lacked: both CLIs print the
    same logo to stderr and exit 0."""
    from sailfish_tpu.cli import main as jax_main
    from sailfish_tpu_torch.cli import main as torch_main

    printed = []
    for main in (jax_main, torch_main):
        assert main(["sf"]) == 0
        out = capsys.readouterr()
        printed.append((out.out, out.err))
    assert printed[0] == printed[1]
    assert "/_/" in printed[1][1] and printed[1][0] == ""
