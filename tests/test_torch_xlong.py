"""Reads over 128 bases through the port against the JAX package's XLA
kernel (kernel="xla": by the JAX package's contracts its Pallas, xlong
and XLA routes give the same hits, and the XLA one has no side effect on
the options) and against the port's numpy reference mapper.  Every
comparison of hits and classes is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu import dna
from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.libformat import parse_library_format as jax_format
from sailfish_tpu.map.encode import make_oriented_lanes as jax_lanes
from sailfish_tpu.map.kernels import map_oriented_lanes as jax_map
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.lanes import map_oriented_lanes
from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend
from sailfish_tpu_torch.refimpl.mapper import RefMapper

from conftest import to_batch
from torch_port import (
    assert_same_quant,
    port_batch,
    port_index,
    run_both_clis,
    write_fasta,
    write_fastq,
)
from torch_port import one_torch_thread  # noqa: F401  (autouse)

B = 48


def _long_reads(toy_world, L, seed):
    """B reads of mixed length up to L from the toy transcripts, with a
    substitution (every 3rd), an N (every 7th), reverse complements
    (every 5th) and two empty rows."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B - 2):
        s = toy_world["seqs"][(i % 6) + 2]          # 600..1100 bases
        U = int(rng.integers(L - 24, L + 1))
        p = int(rng.integers(0, len(s) - U))
        m = s[p:p + U].copy()
        if i % 3 == 0:
            q = int(rng.integers(0, U))
            m[q] = (m[q] + 1) % 4
        if i % 7 == 0:
            m[int(rng.integers(0, U))] = 4
        if i % 5 == 0:
            m = dna.revcomp(m).copy()
        codes[i, :U] = m
        lens[i] = U
    return codes, lens


@pytest.mark.parametrize("L,steps,skip,cap", [
    (152, None, "nip", 16), (304, None, "nip", 16), (152, 40, "jump", 16),
    (304, None, "nip", 2),
])
def test_long_lanes_match_xla_kernel_and_oracle(toy_world, L, steps, skip,
                                                cap):
    idx = toy_world["idx"]
    codes, lens = _long_reads(toy_world, L, seed=L)
    kw = dict(cand_cap=cap, max_mmps=4,
              max_steps=QuantOpts(max_scan_steps=steps or 0)
              .effective_scan_steps(L), skip_jump=(skip == "jump"))
    assert kw["max_steps"] == (steps or L)
    pidx = port_index(idx)
    out = map_oriented_lanes(TorchIndex.from_quasi_index(pidx, "cpu"),
                             torch.from_numpy(codes), torch.from_numpy(lens),
                             **kw)
    port = {k: v.numpy() for k, v in out.items()}

    dev = JaxBackend(idx, JaxOpts(kernel="xla"))
    ref = jax_map(dev.text, jax_lanes(jnp.asarray(codes), jnp.asarray(lens),
                                      idx.prefix_bases),
                  k=idx.k, prefix_bases=idx.prefix_bases, use_hash=True,
                  ht_probes=dev.ht_probes, ht_bits=dev.ht_bits, **kw)
    va, vb = port["valid"], np.asarray(ref["valid"])
    np.testing.assert_array_equal(va, vb)
    for key in ("txp", "pos"):
        np.testing.assert_array_equal(port[key][va],
                                      np.asarray(ref[key])[vb], err_msg=key)
    for key in ("overflow", "num_mapped_loci"):
        np.testing.assert_array_equal(port[key], np.asarray(ref[key]),
                                      err_msg=key)
    # the XLA kernel caps a match at 255 bases (its separator distances
    # are uint8 and saturate); the port and the numpy oracle report the
    # true length, which differs only for matches over 255 bases
    np.testing.assert_array_equal(np.minimum(port["mlen"], 255),
                                  np.asarray(ref["mlen"]))
    assert (port["mlen"] > 255).any() == (L == 304)
    assert va.any() and port["overflow"].any() == (cap == 2)

    if steps is None and skip == "nip":
        # the numpy oracle scans to the read end with the nip rule
        oracle = RefMapper(pidx, QuantOpts(hit_capacity=cap))
        for i in range(B):
            read = codes[i, :lens[i]]
            for row, fwd in ((i, True), (B + i, False)):
                hits, over = oracle._orient_hits(
                    read if fwd else dna.revcomp(read), fwd)
                got = list(zip(port["txp"][row][va[row]].tolist(),
                               port["pos"][row][va[row]].tolist()))
                assert bool(port["overflow"][row]) == over, (i, fwd)
                if not over:
                    assert got == [(h.txp, h.pos)
                                   for _, h in sorted(hits.items())], (i, fwd)
                    if hits:
                        assert {h.mlen for h in hits.values()} \
                            == {int(port["mlen"][row])}, (i, fwd)


@pytest.mark.parametrize("readlen,cap,cap_max", [
    (150, 16, 0), (150, 2, 16), (150, 2, 0), (300, 16, 0)])
def test_long_read_backend_matches_jax(toy_world, readlen, cap, cap_max):
    """Paired long reads through both packages' device backends at the
    same options.  (2, 0): no escalation, the overflowed fragments drop
    in both — the JAX package's xlong route would turn the overflow remap
    on here; its XLA route and the port do not."""
    kw = dict(batch_size=96, hit_capacity=cap, hit_capacity_max=cap_max)
    r1, r2, _ = toy_world["sim"](96, readlen=readlen, flmin=readlen + 20,
                                 flmax=readlen + 200, err_rate=0.3, seed=41)
    ml = (readlen + 7) // 8 * 8
    b1, b2 = to_batch(r1, max_len=ml), to_batch(r2, max_len=ml)
    port = DeviceMapperBackend(port_index(toy_world["idx"]),
                               QuantOpts(**kw), "cpu")
    ref = JaxBackend(toy_world["idx"], JaxOpts(kernel="xla", **kw))
    bp = port.map_pe_batch(port_batch(b1), port_batch(b2),
                           parse_library_format("IU"))
    br = ref.map_pe_batch(b1, b2, jax_format("IU"))
    assert ref.opts.hit_capacity_max == cap_max
    assert (dict(zip(bp.labels, bp.label_counts.tolist()))
            == dict(zip(br.labels, br.label_counts.tolist())))
    for f in ("mapped", "num_joint", "unique_paired", "frag_lens",
              "fmt_counts"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(br, f),
                                      err_msg=f)
    for f in ("num_fwd", "num_rc", "num_compat"):
        assert getattr(bp, f) == getattr(br, f), f
    assert bp.mapped.any()
    if (cap, cap_max) == (2, 0):
        assert not bp.mapped.all()


@pytest.mark.parametrize("readlen", [150, 300])
def test_long_read_cli_matches_jax_cli(toy_world, tmp_path, monkeypatch,
                                       readlen):
    """`quant` on 2 x 150 and 2 x 300 base reads: a batch width of 152
    and 304 (the 300-base mates skip the two shortest transcripts)."""
    from sailfish_tpu_torch.cli import main as torch_main

    d = str(tmp_path)
    fasta = write_fasta(f"{d}/txps.fa", toy_world["names"],
                        toy_world["seqs"])
    r1, r2, _ = toy_world["sim"](160, readlen=readlen, flmin=readlen + 20,
                                 flmax=readlen + 200, err_rate=0.3, seed=7)
    reads = ["-1", write_fastq(f"{d}/r1.fq", r1), "-2",
             write_fastq(f"{d}/r2.fq", r2)]
    idx = f"{d}/idx"
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "31"]) == 0
    outs, got = run_both_clis(monkeypatch, idx, d, "IU", reads,
                              ["--hitCapacity", "2", "--hitCapacityMax",
                               "16"])
    assert_same_quant(outs, got)
    assert got["torch"]["num_escalated"] > 0
