"""The port's mate merge, label hashing and within-batch collapse against
sailfish_tpu.map.pair on hit blocks mapped from the toy world.  Every
comparison is exact (h1/h2 bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.map.pair import collapse_unique as jax_collapse
from sailfish_tpu.map.pair import merge_and_collapse as jax_merge
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.lanes import map_oriented_lanes
from sailfish_tpu_torch.map.pair import collapse_unique, merge_and_collapse
from sailfish_tpu_torch.map.pipeline import fmt_args

from conftest import to_batch
from torch_port import port_index
from torch_port import one_torch_thread  # noqa: F401  (autouse)

C = 16


def _blocks(toy_world, b1, b2):
    """Port hit blocks (fw, rc) for both mates; the scan itself is held
    against the JAX kernels in test_torch_scan.py."""
    tidx = TorchIndex.from_quasi_index(port_index(toy_world["idx"]), "cpu")
    out = []
    for b in (b1, b2):
        h = map_oriented_lanes(tidx, torch.from_numpy(b.codes),
                               torch.from_numpy(b.lens), cand_cap=C,
                               max_mmps=4, max_steps=b.codes.shape[1])
        n = b.codes.shape[0]
        out.append(tuple({k: v[s] for k, v in h.items()
                          if k != "num_mapped_loci"}
                         for s in (slice(0, n), slice(n, 2 * n))))
    return out


@pytest.mark.parametrize("fmt,kw", [
    ("IU", {}),
    ("ISR", {}),
    ("IU", {"allow_orphans": False, "strict_intersect": True}),
    ("ISF", {"enforce_compat": True, "allow_dovetail": True}),
    ("IU", {"max_read_occs": 1}),
])
def test_merge_and_collapse_matches_jax(toy_world, fmt, kw):
    r1, r2, _ = toy_world["sim"](96, err_rate=0.3, seed=17)
    b1, b2 = to_batch(r1), to_batch(r2)
    (f1, c1), (f2, c2) = _blocks(toy_world, b1, b2)
    expected = parse_library_format(fmt)
    orient, strand, se_flags = fmt_args(expected)
    opts = dict(cand_cap=C, max_read_occs=kw.get("max_read_occs", 200),
                allow_orphans=kw.get("allow_orphans", True),
                allow_dovetail=kw.get("allow_dovetail", False),
                ignore_compat=False,
                enforce_compat=kw.get("enforce_compat", False),
                strict_intersect=kw.get("strict_intersect", False))
    port = merge_and_collapse(f1, c1, f2, c2, torch.from_numpy(b1.lens),
                              torch.from_numpy(b2.lens), orient, strand,
                              se_flags, **opts)

    def j(d):
        return {k: jnp.asarray(v.numpy()) for k, v in d.items()}

    ref = jax_merge(j(f1), j(c1), j(f2), j(c2), jnp.asarray(b1.lens),
                    jnp.asarray(b2.lens), jnp.int32(orient),
                    jnp.int32(strand), jnp.asarray(se_flags),
                    paired_end=True, **opts)
    for key in ("label", "label_len", "mapped", "num_joint",
                "unique_paired", "frag_len", "num_fwd", "num_rc",
                "overflow", "fmt_id", "have_compat"):
        np.testing.assert_array_equal(port[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    for key in ("h1", "h2"):
        np.testing.assert_array_equal(
            port[key].numpy().astype(np.uint32), np.asarray(ref[key]),
            err_msg=key)
    assert port["mapped"].any()

    uq, nu = collapse_unique(port["h1"], port["h2"], port["mapped"],
                             port["label_len"])
    uq_ref, nu_ref = jax_collapse(ref["h1"], ref["h2"], ref["mapped"],
                                  ref["label_len"])
    assert int(nu) == int(nu_ref) > 0
    np.testing.assert_array_equal(uq.numpy()[:int(nu)],
                                  np.asarray(uq_ref)[:int(nu)])


def test_hash_collapse_on_random_labels():
    """hash_labels + collapse_unique on random compacted labels with
    repeats and hashes spanning the whole uint32 range (seeded numpy)."""
    from sailfish_tpu.map.pair import _hash_labels as jax_hash
    from sailfish_tpu_torch.map.pair import hash_labels

    rng = np.random.default_rng(23)
    Bn, W = 300, 24
    lens = rng.integers(0, W + 1, 40)
    base = np.full((40, W), -1, np.int32)
    for r, n in enumerate(lens):
        base[r, :n] = np.sort(rng.choice(5000, n, replace=False))
    rows = rng.integers(0, 40, Bn)
    label, count = base[rows], lens[rows].astype(np.int32)
    h1, h2 = hash_labels(torch.from_numpy(label), torch.from_numpy(count))
    r1, r2 = jax_hash(jnp.asarray(label), jnp.asarray(count))
    np.testing.assert_array_equal(h1.numpy().astype(np.uint32),
                                  np.asarray(r1))
    np.testing.assert_array_equal(h2.numpy().astype(np.uint32),
                                  np.asarray(r2))
    mapped = count > 0
    uq, nu = collapse_unique(h1, h2, torch.from_numpy(mapped),
                             torch.from_numpy(count))
    uq_ref, nu_ref = jax_collapse(r1, r2, jnp.asarray(mapped),
                                  jnp.asarray(count))
    assert int(nu) == int(nu_ref)
    np.testing.assert_array_equal(uq.numpy()[:int(nu)],
                                  np.asarray(uq_ref)[:int(nu)])
