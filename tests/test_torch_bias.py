"""The port's bias model against the JAX package's on the toy world, on
the CPU: the merge's joint-hit slots, `bias_observe` against
`bias_observe_device` (exact), the device backend's observations against
the port's host oracle (exact, also through the escalation pass and on a
transcript with an N), `update_effective_lengths` and `run_em_with_bias`
(rtol 1e-9: the same float64 arithmetic in another order of summation;
equal EM iterations)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.index.builder import build_index
from sailfish_tpu.map.pair import merge_and_collapse as jax_merge
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu.stats import bias as jbias
from sailfish_tpu.stats.fld import EmpiricalDistribution
from sailfish_tpu_torch import dna
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.eqclass.classes import EqClasses
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.pair import merge_and_collapse
from sailfish_tpu_torch.map.pipeline import fmt_args, make_backend
from sailfish_tpu_torch.stats import bias as pbias

from conftest import to_batch
from torch_port import (
    copy_bias, hit_blocks, jax_eq, port_batch, port_index, port_slots,
)
from torch_port import one_torch_thread  # noqa: F401  (autouse)

C = 16
NEG = 2**31 - 1
MERGE = dict(cand_cap=C, max_read_occs=200, allow_orphans=True,
             allow_dovetail=False, ignore_compat=False, enforce_compat=False,
             strict_intersect=False)


@pytest.fixture(scope="module")
def pidx(toy_world):
    return port_index(toy_world["idx"])


@pytest.fixture(scope="module")
def merged(toy_world, pidx):
    """One batch of the toy world through both packages' merges with
    return_slots, paired and single-end: {paired: (port, jax, l1, l2)}."""
    r1, r2, _ = toy_world["sim"](128, err_rate=0.3, seed=17)
    b1, b2 = to_batch(r1), to_batch(r2)
    (f1, c1), (f2, c2) = hit_blocks(pidx, (b1, b2), C)
    orient, strand, se_flags = fmt_args(parse_library_format("IU"))
    l1, l2 = torch.from_numpy(b1.lens), torch.from_numpy(b2.lens)

    def j(d):
        return {k: jnp.asarray(v.numpy()) for k, v in d.items()}

    out = {}
    for paired in (True, False):
        port = merge_and_collapse(f1, c1, f2, c2, l1, l2, orient, strand,
                                  se_flags, paired_end=paired,
                                  return_slots=True, **MERGE)
        ref = jax_merge(j(f1), j(c1), j(f2), j(c2), jnp.asarray(b1.lens),
                        jnp.asarray(b2.lens), jnp.int32(orient),
                        jnp.int32(strand), jnp.asarray(se_flags),
                        paired_end=paired, return_slots=True, **MERGE)
        out[paired] = (port["slots"], ref["slots"], l1, l2)
    return out


@pytest.mark.parametrize("paired", [True, False])
def test_slots_match_jax(merged, paired):
    """Exact.  A slot that held no candidate carries the sort's sentinel
    as its txp in both packages; what else it holds is not defined (the
    JAX sort is not stable), so the other fields are compared on the
    slots that held one."""
    port, ref, _, _ = merged[paired]
    assert set(port) == set(ref)
    txp = np.asarray(ref["txp"])
    held = txp != NEG
    np.testing.assert_array_equal(port["txp"].numpy(), txp)
    np.testing.assert_array_equal(port["mapped"].numpy(),
                                  np.asarray(ref["mapped"]))
    np.testing.assert_array_equal(port["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    for key in ("pos", "fwd", "mpos", "mfwd", "status", "frag_len"):
        np.testing.assert_array_equal(port[key].numpy()[held],
                                      np.asarray(ref[key])[held], err_msg=key)
    assert port["valid"].any() and held.sum() >= int(port["valid"].sum())
    if not paired:
        assert not port["mpos"].any() and not port["mfwd"].any()


@pytest.mark.parametrize("flags", [
    dict(bias_correct=True),
    dict(gc_bias_correct=True),
    dict(gc_bias_correct=True, gc_samp_factor=4),
], ids=["seq", "gc", "gc_sampled"])
@pytest.mark.parametrize("paired", [True, False])
def test_bias_observe_matches_jax(toy_world, pidx, merged, flags, paired):
    """`bias_observe` on the JAX merge's slots equals
    `bias_observe_device` on them, sample for sample and bin for bin.
    The toy text holds no N, and its fragments are short enough for the
    JAX path's float32 percentages to be exact."""
    _, ref, l1, l2 = merged[paired]
    on = dict(seq_on=flags.get("bias_correct", False),
              gc_on=flags.get("gc_bias_correct", False))
    jtext = JaxBackend(toy_world["idx"], JaxOpts(**flags)).bias_text
    want_s, want_g = jbias.bias_observe_device(
        ref, jtext, jnp.asarray(l1.numpy()), jnp.asarray(l2.numpy()), **on)
    text = pbias.make_bias_text(pidx, "cpu", QuantOpts(**flags))
    got_s, got_g, got_n = pbias.bias_observe(port_slots(ref), text, l1, l2,
                                             **on)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    assert int(got_n) == int(got_g.sum())
    if on["seq_on"]:
        assert (got_s >= 0).sum() > 32
    elif paired:
        assert int(got_n) > 32
    else:
        assert int(got_n) == 0      # GC needs paired hits


def _n_world(toy_world):
    """The toy transcripts plus one with an N at base 300, and fragments
    whose 6-mer context window lies over that N while the reads do not:
    read 1 forward starting at 301 (window 299..304), and read 1
    reverse-complemented ending at 300 (window 296..301)."""
    rng = np.random.default_rng(99)
    s = rng.integers(0, 4, 700).astype(np.uint8)
    s[300] = dna.SEP
    seqs = list(toy_world["seqs"]) + [s]
    names = list(toy_world["names"]) + ["tN"]
    r1, r2 = [], []
    for fl in (150, 170, 190, 210):
        frag = s[301:301 + fl]
        r1.append(frag[:50].copy())
        r2.append(dna.revcomp(frag[-50:]).copy())
        frag = s[300 - fl:300]
        r1.append(dna.revcomp(frag[-50:]).copy())
        r2.append(frag[:50].copy())
    a1, a2, _ = toy_world["sim"](24, err_rate=0.3, seed=5)
    return build_index(names, seqs, k=31), r1 + a1, r2 + a2


@pytest.fixture(scope="module")
def worlds(toy_world, pidx):
    """{name: (port index, jax index, b1, b2)}: the toy world and the
    world with an N inside a transcript."""
    r1, r2, _ = toy_world["sim"](160, err_rate=0.3, seed=21)
    nidx, n1, n2 = _n_world(toy_world)
    return {"toy": (pidx, toy_world["idx"], to_batch(r1), to_batch(r2)),
            "n": (port_index(nidx), nidx, to_batch(n1), to_batch(n2))}


@pytest.fixture(scope="module")
def oracle_maps(worlds):
    """The host oracle's mapping of each world's batch, once: it does not
    depend on the bias flags, and at --hitCapacity 2 with
    --hitCapacityMax 16 its envelope is the same 16."""
    opts = QuantOpts(hit_capacity=C)
    exp = parse_library_format("IU")
    out = {}
    for name, (idx, _, b1, b2) in worlds.items():
        be = make_backend(idx, opts, "cpu", "refimpl")
        out[name] = be.finish_batch_fast(
            be.submit_pe(port_batch(b1), port_batch(b2), exp),
            be.accumulator())
    return out


def _observe(idx, b1, bs, opts):
    state = pbias.BiasState(opts)
    state.observe_batch(idx, b1, bs)
    return state


@pytest.mark.parametrize("world,flags,caps", [
    ("toy", dict(bias_correct=True), (C, 0)),
    ("toy", dict(gc_bias_correct=True), (C, 0)),
    ("toy", dict(gc_bias_correct=True, gc_samp_factor=4), (C, 0)),
    ("toy", dict(bias_correct=True), (2, C)),
    ("toy", dict(gc_bias_correct=True), (2, C)),
    ("n", dict(bias_correct=True), (C, 0)),
], ids=["seq", "gc", "gc_sampled", "seq_escalated", "gc_escalated",
        "seq_text_n"])
def test_device_observation_matches_oracle(worlds, oracle_maps, world, flags,
                                           caps):
    """The device backend's BiasState equals the host oracle's, integer
    for integer; at --hitCapacity 2 the shared segment's fragments
    overflow and their samples and GC observations come from the
    escalation pass."""
    idx, _, b1, b2 = worlds[world]
    opts = QuantOpts(hit_capacity=caps[0], hit_capacity_max=caps[1], **flags)
    be = make_backend(idx, opts, "cpu", "device")
    bs = be.finish_batch_fast(
        be.submit_pe(port_batch(b1), port_batch(b2),
                     parse_library_format("IU")), be.accumulator())
    assert (bs.num_escalated > 0) == (caps[1] > 0)
    got = _observe(idx, b1, bs, opts)
    want = _observe(idx, b1, oracle_maps[world], opts)
    np.testing.assert_array_equal(got.read_bias_counts, want.read_bias_counts)
    np.testing.assert_array_equal(got.observed_gc, want.observed_gc)
    assert got.remaining_bias_samples == want.remaining_bias_samples
    if flags.get("bias_correct"):
        assert got.read_bias_counts.sum() > 4096 + b1.count // 2
    else:
        assert got.observed_gc.sum() == got.gc_slots > b1.count // 2


def test_text_n_gives_no_sample_unlike_the_jax_device_path(worlds,
                                                           oracle_maps):
    """A 6-mer window over a transcript N.  Both packages' host oracles
    take no sample there (`kmer_index < 0`, the C++ reference's
    behaviour) and so does the port's device path; the JAX package's
    device path reads 2-bit packed text, where the N is an A, and
    counts the window.  The 8 fragments laid over the N are the whole
    difference."""
    idx, jidx, b1, b2 = worlds["n"]
    opts = QuantOpts(hit_capacity=C, bias_correct=True)
    port = _observe(idx, b1, oracle_maps["n"], opts)
    jopts = JaxOpts(hit_capacity=C, bias_correct=True, batch_size=b1.count)
    jdev = jbias.BiasState(jopts)
    jdev.observe_batch(jidx, b1, b2, JaxBackend(jidx, jopts).map_pe_batch(
        b1, b2, parse_library_format("IU")))
    extra = jdev.read_bias_counts - port.read_bias_counts
    assert extra.min() == 0 and extra.sum() == 8
    # the oracle of the JAX package agrees with the port's
    from sailfish_tpu.quant import RefMapperBackend

    jref = jbias.BiasState(jopts)
    jref.observe_batch(jidx, b1, b2, RefMapperBackend(
        jidx, jopts).map_pe_batch(b1, b2, parse_library_format("IU")))
    np.testing.assert_array_equal(jref.read_bias_counts,
                                  port.read_bias_counts)


def _fld(peaks):
    fld = np.zeros(1000, dtype=np.int64)
    for at, n in peaks:
        fld[at] = n
    emp = EmpiricalDistribution(np.arange(1000), fld)
    return emp.pdfvals, emp.cdfvals


@pytest.mark.parametrize("flags,chunk", [
    (dict(bias_correct=True), 1 << 24),
    (dict(bias_correct=True), 1500),
    (dict(gc_bias_correct=True), 1 << 24),
    (dict(gc_bias_correct=True, pdf_samp_factor=3), 1500),
    (dict(gc_bias_correct=True, gc_samp_factor=4), 1500),
], ids=["seq", "seq_chunked", "gc", "gc_speed3_chunked", "gc_sampled"])
def test_update_effective_lengths_matches_jax(toy_world, pidx, flags, chunk):
    """Random observations and abundances through both packages, rtol
    1e-9, also with the positions cut into chunks of one or two
    transcripts; the expected distributions land in the BiasState."""
    idx = toy_world["idx"]
    rng = np.random.default_rng(3)
    seq_obs = rng.integers(40, 60, 4096)
    gc_obs = rng.integers(10, 50, 101)
    T = idx.num_transcripts
    ref_lens = idx.txp_lens.astype(np.float64)
    eff_in = np.maximum(ref_lens - 100.0, 1.0)
    alphas = rng.uniform(20.0, 200.0, T)
    fld = _fld([(150, 200), (180, 500), (220, 300), (260, 50)])
    outs = []
    for mod, opts, text in (
            (jbias, JaxOpts(**flags), idx),
            (pbias, QuantOpts(**flags),
             pbias.make_bias_text(pidx, "cpu", QuantOpts(**flags)))):
        state = mod.BiasState(opts)
        state.read_bias_counts += seq_obs
        state.observed_gc += gc_obs
        kw = {} if mod is jbias else {"chunk_positions": chunk}
        outs.append((mod.update_effective_lengths(
            opts, text, state, fld, eff_in, alphas, 600, 400, **kw), state))
    (want, sw), (got, sg) = outs
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert (got != eff_in).any() and (got > 0).all()
    np.testing.assert_allclose(sg.expected_seq_bias, sw.expected_seq_bias,
                               rtol=1e-9)
    np.testing.assert_allclose(sg.expected_gc, sw.expected_gc, rtol=1e-9)


def test_update_effective_lengths_skips_inactive(toy_world, pidx):
    """Transcripts without abundance keep their input effective length,
    and the one active transcript's equals the JAX package's."""
    idx = toy_world["idx"]
    T = idx.num_transcripts
    eff_in = np.maximum(idx.txp_lens.astype(np.float64) - 150.0, 1.0)
    alphas = np.zeros(T)
    alphas[0] = 50.0
    fld = _fld([(150, 1000)])
    opts = QuantOpts(bias_correct=True)
    got = pbias.update_effective_lengths(
        opts, pbias.make_bias_text(pidx, "cpu", opts), pbias.BiasState(opts),
        fld, eff_in, alphas, 1, 1)
    jopts = JaxOpts(bias_correct=True)
    want = jbias.update_effective_lengths(
        jopts, idx, jbias.BiasState(jopts), fld, eff_in, alphas, 1, 1)
    np.testing.assert_array_equal(got[1:], eff_in[1:])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("flags", [
    dict(bias_correct=True),
    dict(gc_bias_correct=True),
    dict(bias_correct=True, use_vb_opt=True),
], ids=["seq", "gc", "seq_vbem"])
def test_run_em_with_bias_matches_jax(toy_world, pidx, flags):
    """The segmented EM over the classes and observations of one mapped
    batch: equal total iterations (more than 50, so the effective
    lengths were recomputed), alphas and effective lengths at rtol
    1e-9."""
    from sailfish_tpu_torch.quant import ExperimentState, _accumulate
    from sailfish_tpu_torch.stats.fld import effective_lengths_from_fld

    opts = QuantOpts(em_tolerance=1e-7, hit_capacity=C, **flags)
    be = make_backend(pidx, opts, "cpu", "device")
    acc = be.accumulator()
    r1, r2, _ = toy_world["sim"](400, err_rate=0.3, seed=29)
    b1 = port_batch(to_batch(r1))
    bs = be.finish_batch_fast(
        be.submit_pe(b1, port_batch(to_batch(r2)),
                     parse_library_format("IU")), acc)
    state = ExperimentState(remaining_fl_ops=10000,
                            fl_hist=np.zeros(1000, dtype=np.int64))
    _accumulate(bs, state, 1000)
    bias = pbias.BiasState(opts)
    bias.observe_batch(pidx, b1, bs)
    # paired toy fragments map uniquely: add classes over the transcripts
    # that share a segment, so that the EM has something to settle
    # (many more such fragments than unique ones: it settles slowly)
    extra = [((0, 3), 4000), ((3, 6), 3000), ((0, 3, 6), 2500),
             ((1, 2), 2000), ((4, 5, 7), 1500)]
    eq = EqClasses.from_items(
        list(zip(acc.finish().labels(), acc.finish().counts)) + extra)
    state.num_mapped += sum(c for _, c in extra)
    ref_lens = pidx.txp_lens.astype(np.int64)
    eff0, _ = effective_lengths_from_fld(
        ref_lens, state.fl_hist, num_observed=int(state.fl_hist.sum()),
        num_required=100, fld_mean=200, fld_sd=80, max_frag_len=1000,
        use_unsmoothed=False, paired_end=True)

    em, eff, seconds = pbias.run_em_with_bias(
        eq, eff0, be.bias_text, bias, state, opts, device="cpu")
    jopts = JaxOpts(**dataclasses.asdict(opts))
    jstate = copy_bias(bias, jbias.BiasState(jopts))
    # the expected vectors were just overwritten by the port's run
    jem, jeff = jbias.run_em_with_bias(
        jax_eq(eq), eff0, ref_lens, toy_world["idx"], jstate, state, jopts)
    assert em.num_iterations == jem.num_iterations > 50
    assert len(seconds) >= 1
    np.testing.assert_allclose(eff, jeff, rtol=1e-9, atol=0)
    np.testing.assert_allclose(em.alphas, jem.alphas, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(bias.expected_seq_bias,
                               jstate.expected_seq_bias, rtol=1e-9)
    np.testing.assert_allclose(bias.expected_gc, jstate.expected_gc,
                               rtol=1e-9)
    # the update ran: it left its expected distribution behind
    assert (bias.expected_seq_bias != 1).any() or (bias.expected_gc != 1).any()
