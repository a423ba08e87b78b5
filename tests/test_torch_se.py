"""Single-end libraries and the library types besides IU through the
port against the JAX package: the merge (map/pair.py, paired_end=False),
the mapping backend batch by batch, and `quant` through both CLIs —
eq_classes.txt identical, EM iterations equal, alphas at rtol 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.config import QuantOpts as JaxOpts
from sailfish_tpu.libformat import parse_library_format as jax_format
from sailfish_tpu.map.pair import merge_and_collapse as jax_merge
from sailfish_tpu.map.pipeline import DeviceMapperBackend as JaxBackend
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.libformat import (
    all_named_formats,
    parse_library_format,
)
from sailfish_tpu_torch.map.lanes import map_oriented_lanes
from sailfish_tpu_torch.map.pair import merge_and_collapse
from sailfish_tpu_torch.map.pipeline import (
    DeviceMapperBackend,
    fmt_args,
    make_backend,
)

from conftest import to_batch
from torch_port import (
    assert_same_quant,
    port_batch,
    port_index,
    run_both_clis,
    write_world,
)
from torch_port import one_torch_thread  # noqa: F401  (autouse)

C = 16


@pytest.fixture(scope="module")
def pidx(toy_world):
    return port_index(toy_world["idx"])


@pytest.fixture(scope="module")
def world(toy_world, tmp_path_factory):
    """FASTA, mate files and one index directory, written by the port's
    `index` and read by both CLIs."""
    from sailfish_tpu_torch.cli import main as torch_main

    d = str(tmp_path_factory.mktemp("se"))
    fasta, (fq1, fq2) = write_world(toy_world, d, n=300)
    idx = f"{d}/idx"
    assert torch_main(["index", "-t", fasta, "-o", idx, "-k", "31"]) == 0
    return {"idx": idx, "fq1": fq1, "fq2": fq2}


def _mixed_reads(toy_world, n, seed):
    """Single-end reads in both orientations: mate 1 of even fragments,
    mate 2 (the reverse strand) of odd ones."""
    r1, r2, _ = toy_world["sim"](n, err_rate=0.3, seed=seed)
    return [a if i % 2 == 0 else b for i, (a, b) in enumerate(zip(r1, r2))]


@pytest.mark.parametrize("fmt,kw", [
    ("U", {}), ("SF", {}), ("SR", {"enforce_compat": True}),
    ("SF", {"max_read_occs": 1}),
])
def test_single_end_merge_matches_jax(toy_world, pidx, fmt, kw):
    b = to_batch(_mixed_reads(toy_world, 96, seed=19))
    tidx = TorchIndex.from_quasi_index(pidx, "cpu")
    h = map_oriented_lanes(tidx, torch.from_numpy(b.codes),
                           torch.from_numpy(b.lens), cand_cap=C, max_mmps=4,
                           max_steps=b.codes.shape[1])
    n = b.count
    fw, rc = ({k: v[s] for k, v in h.items() if k != "num_mapped_loci"}
              for s in (slice(0, n), slice(n, 2 * n)))
    orient, strand, se_flags = fmt_args(parse_library_format(fmt))
    opts = dict(paired_end=False, cand_cap=C,
                max_read_occs=kw.get("max_read_occs", 200),
                allow_orphans=True, allow_dovetail=False,
                ignore_compat=False,
                enforce_compat=kw.get("enforce_compat", False))
    lens = torch.from_numpy(b.lens)
    port = merge_and_collapse(fw, rc, fw, rc, lens, lens, orient, strand,
                              se_flags, **opts)

    def j(d):
        return {k: jnp.asarray(v.numpy()) for k, v in d.items()}

    jl = jnp.asarray(b.lens)
    ref = jax_merge(j(fw), j(rc), j(fw), j(rc), jl, jl, jnp.int32(orient),
                    jnp.int32(strand), jnp.asarray(se_flags), **opts)
    assert port["label"].shape == (n, 2 * C)
    for key in ("label", "label_len", "mapped", "num_joint",
                "unique_paired", "frag_len", "num_fwd", "num_rc",
                "overflow", "fmt_id", "have_compat"):
        np.testing.assert_array_equal(port[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    for key in ("h1", "h2"):
        np.testing.assert_array_equal(
            port[key].numpy().astype(np.uint32), np.asarray(ref[key]),
            err_msg=key)
    assert port["mapped"].any() and not port["unique_paired"].any()
    assert port["have_compat"].any()
    if fmt != "U":
        assert not port["have_compat"].all()


@pytest.mark.parametrize("fmt", sorted(all_named_formats()))
def test_fmt_args_of_every_library_type(fmt):
    """All 12 library types reach the merge through `fmt_args` with the
    codes the JAX backend passes (DeviceMapperBackend._fmt_args)."""
    o, s, flags = fmt_args(parse_library_format(fmt))
    jo, js, jflags = JaxBackend._fmt_args(None, jax_format(fmt))
    assert (o, s) == (int(jo), int(js))
    assert list(flags) == [bool(x) for x in np.asarray(jflags)]


@pytest.mark.parametrize("fmt,cap,cap_max", [
    ("U", 16, 0), ("SF", 16, 0), ("SR", 2, 16)])
def test_single_end_backend_matches_jax(toy_world, pidx, fmt, cap, cap_max):
    """`map_se_batch` of both device backends, and the port's refimpl
    backend; (2, 16) sends the overflowed reads through the escalation
    pass."""
    kw = dict(batch_size=160, hit_capacity=cap, hit_capacity_max=cap_max)
    b = to_batch(_mixed_reads(toy_world, 160, seed=23))
    pb = port_batch(b)
    pexp = parse_library_format(fmt)
    port = DeviceMapperBackend(pidx, QuantOpts(**kw), "cpu")
    ref = JaxBackend(toy_world["idx"], JaxOpts(kernel="xla", **kw))
    bp = port.map_se_batch(pb, pexp)
    br = ref.map_se_batch(b, jax_format(fmt))
    assert (dict(zip(bp.labels, bp.label_counts.tolist()))
            == dict(zip(br.labels, br.label_counts.tolist())))
    for f in ("mapped", "num_joint", "unique_paired", "frag_lens",
              "fmt_counts"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(br, f),
                                      err_msg=f)
    for f in ("num_fwd", "num_rc", "num_compat"):
        assert getattr(bp, f) == getattr(br, f), f
    assert bp.mapped.any() and not bp.unique_paired.any()

    stats, accs = {}, {}
    for name in ("device", "refimpl"):
        be = make_backend(pidx, QuantOpts(**kw), "cpu", name)
        accs[name] = be.accumulator()
        stats[name] = be.finish_batch_fast(be.submit_se(pb, pexp),
                                           accs[name])
    d, r = stats["device"], stats["refimpl"]
    assert accs["refimpl"]._counts == accs["device"]._counts
    assert accs["device"]._counts == dict(zip(bp.labels,
                                              bp.label_counts.tolist()))
    for f in ("n", "num_mapped", "sum_joint", "ub_hits", "num_fwd",
              "num_rc", "fld_count", "num_compat"):
        assert getattr(r, f) == getattr(d, f), f
    np.testing.assert_array_equal(r.fmt_counts, d.fmt_counts)
    assert d.fld_count == 0
    assert (d.num_escalated > 0) == bool(cap_max)


@pytest.mark.parametrize("lib,flags", [
    ("U", []), ("SF", []), ("SR", ["--enforceLibCompat"]),
    ("U", ["--fldMean", "150", "--fldSD", "30"]),
    ("ISF", []), ("OU", []),
    ("IU", ["--strictIntersect"]), ("IU", ["--discardOrphans"]),
    ("ISR", ["--allowDovetail", "--useVBOpt"]),
])
def test_quant_library_types_match_jax_cli(world, tmp_path, monkeypatch,
                                           lib, flags):
    paired = parse_library_format(lib).type.name == "PAIRED_END"
    reads = (["-1", world["fq1"], "-2", world["fq2"]] if paired
             else ["-r", world["fq1"], world["fq2"]])
    outs, got = run_both_clis(
        monkeypatch, world["idx"], str(tmp_path), lib, reads,
        ["--hitCapacity", "2", "--hitCapacityMax", "16", *flags])
    assert_same_quant(outs, got)
    assert got["torch"]["num_observed"] == (300 if paired else 600)
    assert got["torch"]["num_escalated"] > 0
