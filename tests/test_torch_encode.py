"""The port's read encoding against the JAX package: oriented lanes and
A-substituted packed words against map/encode.make_oriented_lanes, the
N mask against map/pallas_kernel._build_lanes, and the 2-bit H2D pack /
unpack round trip against map/pipeline._pack_reads.  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.map.encode import make_oriented_lanes as jax_lanes
from sailfish_tpu.map.pallas_kernel import _build_lanes
from sailfish_tpu.map.pipeline import _pack_reads
from sailfish_tpu_torch.map.encode import (
    make_oriented_lanes,
    pack_reads,
    unpack_reads,
)
from torch_port import one_torch_thread  # noqa: F401  (autouse)


def _reads(seed, B=48, L=56):
    """Random reads of mixed lengths with N bases and padding rows."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    codes[rng.random((B, L)) < 0.03] = 4
    lens[-2:] = 0
    for i, n in enumerate(lens):
        codes[i, n:] = 4
    return codes, lens


@pytest.mark.parametrize("seed,L", [(0, 56), (1, 128), (2, 37)])
def test_lanes_match_jax(seed, L):
    codes, lens = _reads(seed, L=L)
    port = make_oriented_lanes(torch.from_numpy(codes),
                               torch.from_numpy(lens))
    ref = jax_lanes(jnp.asarray(codes), jnp.asarray(lens), 10)
    np.testing.assert_array_equal(port["codes"].numpy(),
                                  np.asarray(ref["codes"]))
    np.testing.assert_array_equal(port["lens"].numpy(),
                                  np.asarray(ref["lens"]))
    np.testing.assert_array_equal(port["pw"].numpy(),
                                  np.asarray(ref["pw_a"]).view(np.int32))
    # the N mask and orientation against the TPU kernel's lane build
    _, nmask, has_n, olens, oc, _, NB = _build_lanes(
        jnp.asarray(codes), None, None, jnp.asarray(lens), None, L)
    bits = np.unpackbits(np.asarray(nmask).view(np.uint8), axis=1,
                         bitorder="little")[:, :L].astype(bool)
    np.testing.assert_array_equal(port["nmask"].numpy(), bits)
    np.testing.assert_array_equal(port["codes"].numpy(), np.asarray(oc))
    np.testing.assert_array_equal(port["lens"].numpy(), np.asarray(olens))
    live = np.arange(L)[None, :] < port["lens"].numpy()[:, None]
    np.testing.assert_array_equal((port["nmask"].numpy() & live).any(1),
                                  np.asarray(has_n))


@pytest.mark.parametrize("seed,L", [(3, 56), (4, 100), (5, 128)])
def test_pack_round_trip(seed, L):
    codes, _ = _reads(seed, L=L)
    pw, nm = pack_reads(codes)
    pw_j, nm_j = _pack_reads(codes)
    np.testing.assert_array_equal(pw, pw_j)
    np.testing.assert_array_equal(nm, nm_j)
    back = unpack_reads(torch.from_numpy(pw.view(np.int32)),
                        torch.from_numpy(nm.view(np.int32)), L)
    np.testing.assert_array_equal(back.numpy(), codes)
