"""The port's posterior samplers on hand-made equivalence classes, on the
CPU.  Torch's random streams are not JAX's, so nothing is compared draw
by draw: the stacked bootstrap EM is fed the same redrawn counts as the
JAX package's (rtol 1e-9), the redrawing is held by its moments, and the
Gibbs chain by its first two moments against the port's sequential
reference chain, whose numpy stream does equal the original's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sailfish_tpu.infer import bootstrap as jboot
from sailfish_tpu.infer import gibbs as jgibbs
from sailfish_tpu.infer.em import class_weights as jax_weights
from sailfish_tpu.refimpl.gibbs import run_gibbs_sequential as jax_sequential
from sailfish_tpu_torch.eqclass.classes import EqClasses
from sailfish_tpu_torch.infer import bootstrap as pboot
from sailfish_tpu_torch.infer import gibbs as pgibbs
from sailfish_tpu_torch.infer.em import _Problem, run_em
from sailfish_tpu_torch.refimpl.gibbs import run_gibbs_sequential

from torch_port import jax_eq
from torch_port import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def world():
    eq = EqClasses.from_items([
        ((0,), 500), ((1,), 300), ((0, 1), 200), ((2,), 100), ((1, 2), 60)])
    eff = np.array([1000.0, 1000.0, 500.0])
    total = float(eq.total_count())
    em = run_em(eq, eff, total, 3, device="cpu")
    return eq, eff, total, em


def _random_classes(seed, num_txps=60, num_classes=400):
    """Classes of 1 to 9 transcripts with skewed membership, so that some
    transcripts sit in many classes (many colours) and sizes span several
    tiers."""
    rng = np.random.default_rng(seed)
    seen, items = set(), []
    while len(items) < num_classes:
        n = int(rng.integers(1, 10))
        pool = num_txps if rng.random() < 0.5 else 12
        label = tuple(sorted(rng.choice(pool, min(n, pool), replace=False)))
        if label not in seen:
            seen.add(label)
            items.append((label, int(rng.integers(1, 200))))
    return EqClasses.from_items(items), num_txps


@pytest.mark.parametrize("use_vbem", [False, True], ids=["em", "vbem"])
def test_stacked_bootstrap_em_matches_jax(use_vbem):
    """The same redrawn counts through both packages' stacked EM: alphas
    at rtol 1e-9.  Replicate 0 keeps the observed counts, the others are
    multinomial redraws, and they stop at different iterations; a
    replicate run alone gives what it gives in the stack."""
    eq, T = _random_classes(1)
    rng = np.random.default_rng(2)
    eff = rng.uniform(300.0, 3000.0, T)
    total = eq.total_count()
    counts_r = np.stack([eq.counts] + [
        rng.multinomial(total, eq.counts / total) for _ in range(4)]
    ).astype(np.float64)
    active = np.zeros(T, dtype=bool)
    active[np.unique(eq.members)] = True
    alpha0 = np.where(active, total / active.sum(), 0.0)
    kw = dict(use_vbem=use_vbem, max_iter=10000, rel_diff_tol=0.01)

    want = jboot._bootstrap_em(
        jnp.asarray(eq.members, jnp.int32),
        jnp.asarray(eq.class_of_member(), jnp.int32), jnp.asarray(counts_r),
        jnp.asarray(jax_weights(jax_eq(eq), eff)),
        jnp.asarray(eq.class_sizes() == 1), jnp.asarray(alpha0),
        num_txps=T, **kw)

    def stacked(rows):
        p = _Problem(eq, eff, T, torch.device("cpu"), torch.float64,
                     counts=torch.from_numpy(counts_r[rows]))
        return pboot.bootstrap_em(p, torch.from_numpy(alpha0), **kw)

    got, iters = stacked(slice(None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    assert len(set(iters.tolist())) > 1 and int(iters.min()) >= 1
    for r in (0, int(iters.argmin()), int(iters.argmax())):
        alone, it = stacked(slice(r, r + 1))
        assert int(it[0]) == int(iters[r])
        np.testing.assert_allclose(alone[0].numpy(), got[r].numpy(),
                                   rtol=1e-12, atol=0)


def test_multinomial_counts_moments_and_seed():
    """Redrawn counts sum to the total exactly, their mean over 200
    redraws is within 5 standard errors of total * p, one seed gives one
    sequence of draws, and uniforms drawn 1,000 at a time serve as
    well."""
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 400, 50).astype(np.float64)
    total = int(counts.sum())
    p = counts / total
    cdf = torch.from_numpy(np.cumsum(p))

    def draws(seed, n, **kw):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return torch.stack([pboot.multinomial_counts(gen, cdf, total, **kw)
                            for _ in range(n)]).numpy()

    for kw in ({}, {"chunk": 1000}):
        d = draws(7, 200, **kw)
        assert (d.sum(axis=1) == total).all() and (d >= 0).all()
        se = np.sqrt(total * p * (1 - p) / 200)
        assert (np.abs(d.mean(axis=0) - total * p) <= 5 * se).all()
        assert d.std(axis=0).min() > 0
    np.testing.assert_array_equal(draws(7, 3), draws(7, 200)[:3])
    assert (draws(8, 3) != draws(7, 3)).any()


@pytest.mark.parametrize("use_vbem", [False, True], ids=["em", "vbem"])
def test_run_bootstraps(world, use_vbem):
    """The gates of tests/test_samplers.py: every replicate conserves the
    total (VBEM adds its 0.01 prior a transcript), the replicate mean is
    within 15 % of the point estimate, replicates differ, and the seed
    fixes them."""
    eq, eff, total, em = world
    kw = dict(device="cpu", use_vbem=use_vbem, seed=1)
    mat = np.stack(list(pboot.run_bootstraps(eq, eff, 3, num_bootstraps=30,
                                             **kw)))
    assert mat.shape == (30, 3) and mat.dtype == np.float64
    np.testing.assert_allclose(mat.sum(axis=1), total,
                               rtol=0.01 if use_vbem else 1e-6)
    np.testing.assert_allclose(mat.mean(axis=0), em.alphas, rtol=0.15)
    assert mat.std(axis=0).max() > 1.0
    again = np.stack(list(pboot.run_bootstraps(eq, eff, 3, num_bootstraps=3,
                                               **kw)))
    np.testing.assert_array_equal(again, mat[:3])


def test_gibbs_samples(world):
    eq, eff, total, em = world
    mat = np.stack(list(pgibbs.run_gibbs(
        eq, eff, em.alphas, 3, device="cpu", num_samples=20,
        total_mapped=total, seed=3, num_chains=2)))
    assert mat.shape == (20, 3) and mat.dtype == np.int32
    # every sample is a valid allocation: totals conserved exactly
    assert (mat.sum(axis=1) == int(total)).all()
    # singleton-class floors: txp 0 always holds its 500 unique reads
    assert (mat >= np.array([500, 300, 100])).all()
    np.testing.assert_allclose(mat.mean(axis=0), em.alphas, rtol=0.25)
    assert (mat.std(axis=0) > 0).any()
    again = np.stack(list(pgibbs.run_gibbs(
        eq, eff, em.alphas, 3, device="cpu", num_samples=4,
        total_mapped=total, seed=3, num_chains=2)))
    np.testing.assert_array_equal(again, mat[:4])


def test_gibbs_matches_sequential_reference_chain(world):
    """The wave chain against the port's sequential port of the
    reference chain, 600 samples each: means within 5 combined standard
    errors plus 2, spreads within 20 %."""
    eq, eff, total, em = world
    n = 600
    seq = np.stack(list(run_gibbs_sequential(
        eq, eff, em.alphas, 3, num_samples=n, total_mapped=total, seed=11)))
    blk = np.stack(list(pgibbs.run_gibbs(
        eq, eff, em.alphas, 3, device="cpu", num_samples=n,
        total_mapped=total, seed=12, num_chains=4)))
    assert (seq.sum(axis=1) == int(total)).all()
    assert (blk.sum(axis=1) == int(total)).all()
    ms, mb = seq.mean(axis=0), blk.mean(axis=0)
    ss, sb = seq.std(axis=0), blk.std(axis=0)
    se = (ss + sb) / np.sqrt(n)
    assert np.all(np.abs(ms - mb) <= 5.0 * se + 2.0), (ms, mb, se)
    np.testing.assert_allclose(sb, ss, rtol=0.20)


def test_gibbs_on_many_classes_conserves_totals():
    """Several colours, waves and tiers: each sample sums to the mapped
    total exactly and no transcript falls under its singleton classes'
    counts."""
    eq, T = _random_classes(5)
    eff = np.random.default_rng(6).uniform(300.0, 3000.0, T)
    total = float(eq.total_count())
    em = run_em(eq, eff, total, T, device="cpu")
    tiers = pgibbs._build_schedule(eq, pgibbs.color_classes(eq))
    size = pgibbs.schedule_launches(tiers)
    assert size["waves"] > 4 and len(size["tiers"]) > 1
    mat = np.stack(list(pgibbs.run_gibbs(
        eq, eff, em.alphas, T, device="cpu", num_samples=4,
        total_mapped=total, seed=1, inner_rounds=3)))
    assert (mat.sum(axis=1) == int(total)).all()
    single = eq.class_sizes() == 1
    floor = np.bincount(eq.members[np.repeat(single, eq.class_sizes())],
                        weights=eq.counts[single], minlength=T)
    assert (mat >= floor).all() and (mat.std(axis=0) > 0).any()


def test_sequential_chain_equals_the_original(world):
    """The port's copy of refimpl/gibbs.py: one numpy seed, the same
    samples."""
    eq, eff, total, em = world
    kw = dict(num_samples=5, total_mapped=total, seed=4)
    got = list(run_gibbs_sequential(eq, eff, em.alphas, 3, **kw))
    want = list(jax_sequential(jax_eq(eq), eff, em.alphas, 3, **kw))
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("seed", [5, 8])
def test_schedule_equals_the_original(seed):
    """`color_classes`, `_build_schedule` and `_init_allocations` are
    host copies: equal to the originals, array for array."""
    eq, T = _random_classes(seed)
    colors = pgibbs.color_classes(eq)
    np.testing.assert_array_equal(colors, jgibbs.color_classes(jax_eq(eq)))
    got = pgibbs._build_schedule(eq, colors)
    want = jgibbs._build_schedule(jax_eq(eq), colors)
    assert [L for _, L in got] == [L for _, L in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    p = np.random.default_rng(seed).uniform(0.1, 1.0, eq.num_members)
    for a, b in zip(
            pgibbs._init_allocations(np.random.default_rng(1), eq, p, 2),
            jgibbs._init_allocations(np.random.default_rng(1), jax_eq(eq),
                                     p, 2)):
        np.testing.assert_array_equal(a, b)
