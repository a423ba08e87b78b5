"""The port's EM / VBEM (torch, float64, CPU) against
sailfish_tpu.infer.em.run_em (jax, float64): same iteration count and
alphas within rtol 1e-9 (both sum in float64; the segment sums may
associate in another order, which moves the last bits only)."""

import numpy as np
import pytest

from sailfish_tpu.eqclass.classes import EqClasses
from sailfish_tpu.infer.em import run_em as jax_run_em
from sailfish_tpu_torch.infer.em import run_em
from torch_port import one_torch_thread  # noqa: F401  (autouse)


def _problem(seed: int, num_txps: int = 60, num_classes: int = 150):
    """Random eq classes (singletons and multi-member classes, a few
    transcripts never hit) and effective lengths from a numpy seed."""
    rng = np.random.default_rng(seed)
    items = {}
    for _ in range(num_classes):
        size = int(rng.choice([1, 1, 2, 3, 5, 8]))
        label = tuple(sorted(rng.choice(num_txps - 5, size, replace=False)
                             .tolist()))
        items[label] = items.get(label, 0) + int(rng.integers(1, 400))
    eq = EqClasses.from_items(sorted(items.items()))
    eff = rng.uniform(20.0, 3000.0, num_txps)
    return eq, eff, float(eq.total_count())


@pytest.mark.parametrize("use_vbem", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_em_matches_jax(seed, use_vbem):
    eq, eff, total = _problem(seed)
    kw = dict(use_vbem=use_vbem, rel_diff_tol=0.01, max_iter=10000)
    ref = jax_run_em(eq, eff, total, len(eff), dtype="float64", **kw)
    got = run_em(eq, eff, total, len(eff), device="cpu", **kw)
    assert got.num_iterations == ref.num_iterations
    assert got.converged == ref.converged
    np.testing.assert_allclose(got.alphas, ref.alphas, rtol=1e-9, atol=0)
    np.testing.assert_allclose(got.max_rel_diff, ref.max_rel_diff,
                               rtol=1e-6)
    assert got.alphas.sum() > 0


def test_em_iteration_cap_matches_jax():
    """A max_iter below convergence stops both at the same alphas."""
    eq, eff, total = _problem(3)
    ref = jax_run_em(eq, eff, total, len(eff), dtype="float64",
                     min_iter=5, max_iter=7, rel_diff_tol=1e-12)
    got = run_em(eq, eff, total, len(eff), device="cpu", min_iter=5,
                 max_iter=7, rel_diff_tol=1e-12)
    assert got.num_iterations == ref.num_iterations == 7
    assert not got.converged and not ref.converged
    np.testing.assert_allclose(got.alphas, ref.alphas, rtol=1e-9, atol=0)
