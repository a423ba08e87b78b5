"""The port's scan (plain torch version + post-pass) against the JAX
package's Pallas kernel (interpret mode) and XLA kernel, on the toy
world.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.config import QuantOpts
from sailfish_tpu.map.encode import make_oriented_lanes as jax_lanes
from sailfish_tpu.map.kernels import map_oriented_lanes as jax_map
from sailfish_tpu.map.pallas_kernel import (
    map_oriented_lanes_pallas,
    prepare_pallas_text,
)
from sailfish_tpu.map.pipeline import DeviceMapperBackend
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.map.encode import make_oriented_lanes
from sailfish_tpu_torch.map.lanes import map_oriented_lanes
from sailfish_tpu_torch.map.scan import mmp_scan, mmp_scan_reference

from torch_port import port_index, risk_reads
from torch_port import one_torch_thread  # noqa: F401  (autouse)

B, L, U = 64, 56, 50   # tests/test_pallas.py shapes
RISK_L = 104           # wide enough for miss chains longer than 32


def _reads(toy_world, seed=3):
    """Reads of 50 bases from the toy transcripts with substitution
    errors (every 3rd) and an N base (every 7th), as test_pallas.py."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.full(B, U, np.int32)
    for i in range(B):
        s = toy_world["seqs"][i % len(toy_world["seqs"])]
        p = int(rng.integers(0, len(s) - U))
        m = s[p:p + U].copy()
        if i % 3 == 0:
            q = int(rng.integers(0, U))
            m[q] = (m[q] + 1) % 4
        if i % 7 == 0:
            m[10] = 4
        codes[i, :U] = m
    return codes, lens


def _port(toy_world, codes, lens, **kw):
    tidx = TorchIndex.from_quasi_index(port_index(toy_world["idx"]), "cpu")
    out = map_oriented_lanes(tidx, torch.from_numpy(codes),
                             torch.from_numpy(lens), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same(port, ref):
    """Exact equality at the post-pass level: valid masks, txp/pos at
    valid slots, mlen, overflow, loci counts."""
    va, vb = port["valid"], np.asarray(ref["valid"])
    np.testing.assert_array_equal(va, vb)
    for key in ("txp", "pos"):
        np.testing.assert_array_equal(port[key][va], np.asarray(ref[key])[vb],
                                      err_msg=key)
    for key in ("mlen", "overflow", "num_mapped_loci"):
        np.testing.assert_array_equal(port[key], np.asarray(ref[key]),
                                      err_msg=key)


# (reads, max_steps, skip rule, candidate capacity); max_steps None = the
# full budget.  "toy" are the reads of `_reads`; "risk" those of
# torch_port.risk_reads at RISK_L, with step budgets that end before,
# at and behind a 32-position probe window
CASES = [
    ("toy", 4, "nip", 16),
    ("toy", None, "nip", 16),
    ("toy", 4, "jump", 16),
    ("toy", None, "jump", 16),
    ("toy", None, "nip", 2),
    ("risk", 1, "nip", 16),
    ("risk", 31, "nip", 16),
    ("risk", 32, "nip", 16),
    ("risk", 33, "nip", 16),
    ("risk", None, "nip", 16),
    ("risk", None, "jump", 16),
    ("risk", 33, "jump", 16),
    ("risk", None, "nip", 2),
    ("risk", 33, "nip", 2),
]


@pytest.mark.parametrize(
    "reads,steps,skip,cap", CASES,
    ids=["-".join(str(x) for x in c[c[0] == "toy":]) for c in CASES])
def test_scan_matches_xla_kernel(toy_world, reads, steps, skip, cap):
    idx = toy_world["idx"]
    dev = DeviceMapperBackend(idx, QuantOpts())
    if reads == "toy":
        codes, lens = _reads(toy_world)
    else:
        codes, lens = risk_reads(toy_world["seqs"], idx.k, RISK_L, seed=23)
    L = codes.shape[1]
    kw = dict(cand_cap=cap, max_mmps=4, max_steps=steps or L,
              skip_jump=(skip == "jump"))
    lanes = jax_lanes(jnp.asarray(codes), jnp.asarray(lens),
                      idx.prefix_bases)
    ref = jax_map(dev.text, lanes, k=idx.k, prefix_bases=idx.prefix_bases,
                  use_hash=True, ht_probes=dev.ht_probes,
                  ht_bits=dev.ht_bits, **kw)
    port = _port(toy_world, codes, lens, **kw)
    _assert_same(port, ref)
    if cap == 2 and steps is None:
        # the toy world's shared 100bp segment puts 3 copies of its
        # k-mers in the text: C = 2 must overflow those lanes
        assert port["overflow"].any()
    elif cap != 2:
        assert not port["overflow"].any()
    assert port["valid"].any()


# one interpret-mode case (about 90 s on the CPU): the XLA comparison
# above already covers the jump rule and the full step budget
@pytest.mark.parametrize("steps,skip", [(4, "nip")])
def test_scan_matches_pallas_kernel(toy_world, steps, skip):
    idx = toy_world["idx"]
    dev = DeviceMapperBackend(idx, QuantOpts())
    codes, lens = _reads(toy_world)
    pt = prepare_pallas_text(idx, cand_cap=16)
    ref = map_oriented_lanes_pallas(
        pt, jnp.asarray(codes), jnp.asarray(lens), k=idx.k, cand_cap=16,
        max_mmps=4, max_steps=steps or L, ht_bits=dev.ht_bits,
        ht_probes=dev.ht_probes, skip_jump=(skip == "jump"), interpret=True)
    port = _port(toy_world, codes, lens, cand_cap=16, max_mmps=4,
                 max_steps=steps or L, skip_jump=(skip == "jump"))
    _assert_same(port, ref)


def test_dispatch_runs_plain_version_on_cpu(toy_world):
    """On CPU tensors `mmp_scan` is the plain version, bit for bit, and
    launches no kernel."""
    from sailfish_tpu_torch.map.scan import mmp_scan_cuda

    tidx = TorchIndex.from_quasi_index(port_index(toy_world["idx"]), "cpu")
    codes, lens = _reads(toy_world, seed=5)
    lanes = make_oriented_lanes(torch.from_numpy(codes),
                                torch.from_numpy(lens))
    before = mmp_scan_cuda.launches
    kw = dict(cand_cap=16, max_mmps=4, max_steps=L)
    a = mmp_scan(lanes, tidx, **kw)
    b = mmp_scan_reference(lanes, tidx, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert mmp_scan_cuda.launches == before
    with pytest.raises(ValueError):
        mmp_scan_cuda(lanes, tidx, **kw)


@pytest.mark.parametrize("cap", [16, 2])
def test_work_counters_of_the_plain_version(toy_world, cap):
    """`work` reports what the inputs made the scan do and changes no
    output: at least one table row per probed position, every stored
    candidate read from the suffix array, every valid slot a stored
    candidate, at least k text bytes compared for a candidate that
    reached a match, every MMP found from a seed (a probed position whose
    k-mer has at most cand_cap candidates), at most cand_cap candidates a
    seed, and between one and ceil(50 / 16) text chunks a candidate."""
    tidx = TorchIndex.from_quasi_index(port_index(toy_world["idx"]), "cpu")
    codes, lens = _reads(toy_world, seed=5)
    lanes = make_oriented_lanes(torch.from_numpy(codes),
                                torch.from_numpy(lens))
    kw = dict(cand_cap=cap, max_mmps=4, max_steps=L)
    work = {}
    a = mmp_scan_reference(lanes, tidx, work=work, **kw)
    b = mmp_scan_reference(lanes, tidx, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert set(work) == {"buckets", "candidates", "text_bytes", "stored",
                         "seeds", "chunks"}
    assert all(isinstance(v, int) for v in work.values())
    steps = int(a[3][:, 3].sum())
    assert steps <= work["buckets"] <= steps * tidx.ht_probes
    assert work["candidates"] >= work["stored"] >= int(a[2].sum()) > 0
    assert work["text_bytes"] >= tidx.k * int(a[2].sum())
    assert work["text_bytes"] <= work["candidates"] * (U + 1)
    assert int(a[3][:, 0].sum()) <= work["seeds"] <= steps
    assert work["candidates"] <= cap * work["seeds"]
    assert work["candidates"] <= work["chunks"] <= 4 * work["candidates"]


def test_index_text_is_padded_and_hits_are_unchanged(toy_world):
    """The uploaded text carries TEXT_PAD trailing bytes of code 4 behind
    the true text, `n_text` stays the true length, and the hits of reads
    that end on or run past the text's last base are those of the XLA
    kernel (which knows no padding)."""
    from sailfish_tpu_torch.index.device import TEXT_PAD

    idx = toy_world["idx"]
    tidx = TorchIndex.from_quasi_index(port_index(idx), "cpu")
    n = len(idx.codes)
    assert TEXT_PAD == 16 and tidx.n_text == n
    assert tidx.codes.shape == (n + TEXT_PAD,)
    np.testing.assert_array_equal(tidx.codes[:n].numpy(), idx.codes)
    assert (tidx.codes[n - 1:] == 4).all()
    assert tidx.sa.shape == (n,) and tidx.txp_of_pos.shape == (n,)

    last = toy_world["seqs"][-1]
    rng = np.random.default_rng(29)
    reads = [last[len(last) - U:],
             np.concatenate([last[len(last) - 40:],
                             rng.integers(0, 4, U - 40).astype(np.uint8)])]
    codes = np.full((2, L), 4, np.uint8)
    for i, m in enumerate(reads):
        codes[i, :U] = m
    lens = np.full(2, U, np.int32)
    kw = dict(cand_cap=16, max_mmps=4, max_steps=L, skip_jump=False)
    dev = DeviceMapperBackend(idx, QuantOpts())
    ref = jax_map(dev.text, jax_lanes(jnp.asarray(codes), jnp.asarray(lens),
                                      idx.prefix_bases),
                  k=idx.k, prefix_bases=idx.prefix_bases, use_hash=True,
                  ht_probes=dev.ht_probes, ht_bits=dev.ht_bits, **kw)
    port = _port(toy_world, codes, lens, **kw)
    _assert_same(port, ref)
    # both reads map, forward, to the last transcript; the second's match
    # ends at the text's final separator
    assert port["valid"][:2].any(axis=1).all()
    assert port["mlen"][0] == U and port["mlen"][1] == 40
