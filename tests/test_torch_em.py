"""The port's EM / VBEM (torch, float64, CPU) against
sailfish_tpu.infer.em.run_em (jax, float64): same iteration count and
alphas within rtol 1e-9 (both sum in float64; the segment sums may
associate in another order, which moves the last bits only).  The EM
kernel's layout (the transcript-major order, the chunk records, its
tables run as its phases run them) against numpy, loops and
`_em_step`, and the choice of path `run_em` makes; on the card, the
kernel (csrc/em.cu) against the plain torch loop on the CPU.

The card tests import no jax: on the card run them with
`python -m pytest tests/test_torch_em.py -m card --noconftest`."""

import numpy as np
import pytest
import torch

from sailfish_tpu.eqclass.classes import EqClasses
from sailfish_tpu_torch import trace
from sailfish_tpu_torch.infer import em as port_em
from sailfish_tpu_torch.infer.em import run_em
from torch_port import one_torch_thread  # noqa: F401  (autouse)


def jax_run_em(*args, **kw):
    from sailfish_tpu.infer.em import run_em as jax_em

    return jax_em(*args, **kw)


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


@pytest.mark.parametrize("seed,num_txps,num_classes", [
    (1, 60, 150), (2, 60, 150), (3, 9, 400), (4, 500, 40), (5, 1, 1)])
def test_transcript_major_matches_numpy(seed, num_txps, num_classes):
    """The kernel's transcript-major order is numpy's stable argsort of
    the members, its offsets each transcript's first member there (the
    transcripts no class holds, at either end too, get empty ranges)."""
    eq, eff, _ = _problem(seed, num_txps + 5, num_classes) \
        if num_txps > 1 else (EqClasses.from_items([((0,), 3)]),
                              np.ones(1), 3.0)
    T = len(eff) + 3
    members = torch.as_tensor(eq.members, dtype=torch.int64)
    order, offsets = port_em.transcript_major(members, T)
    want = np.argsort(eq.members, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(
        offsets.numpy(), np.searchsorted(eq.members[want], np.arange(T + 1)))
    assert offsets[-1] == len(eq.members)


def _chunks_by_loop(offsets):
    """The chunk records of `port_em.chunk_table`, row by row."""
    chunk = port_em.EM_CHUNK
    recs = []
    for r in range(len(offsets) - 1):
        lo, hi = int(offsets[r]), int(offsets[r + 1])
        starts = list(range(lo, hi, chunk))
        first = len(recs)
        for j in starts:
            recs.append((r, j, min(chunk, hi - j) | (len(starts) << 8),
                         first))
    return recs


@pytest.mark.parametrize("lens", [
    [0, 5, 0, 0, 17, 8, 9, 1, 0], [1], [0, 0, 2], [3, 2, 40, 64, 0],
    [8] * 20 + [0] * 7, [7], [8], [9], [15, 16, 17], [0, 0, 0, 0],
    [1] * 33, [0, 64, 0, 63, 0, 65], [2, 0] * 12, [255], [24, 1, 0, 23]])
def test_chunk_table_matches_loop(lens):
    """Every row gets its chunks in order, each of at most EM_CHUNK
    entries, with the row's chunk count and first chunk, and an empty row
    none; the records past the last chunk are padding (row -1), and there
    are R + ceil(entries / EM_CHUNK) records in all."""
    offsets = np.concatenate([[0], np.cumsum(lens)])
    got = port_em.chunk_table(torch.as_tensor(offsets),
                              int(offsets[-1])).numpy()
    want = _chunks_by_loop(offsets)
    assert got.dtype == np.int32
    assert got.shape == (len(lens) + -(-int(offsets[-1]) // port_em.EM_CHUNK),
                         4)
    assert [tuple(x) for x in got[:len(want)]] == want
    assert (got[len(want):, 0] == -1).all()


def _phase_by_chunks(rec, term):
    """The sums a kernel phase makes from chunk records: each chunk's
    terms in entry order, a longer row's chunk sums in chunk order."""
    sums, parts = {}, {}
    for k, (r, j0, z, first) in enumerate(rec):
        if r >= 0:
            s = 0.0
            for j in range(j0, j0 + (z & 0xFF)):
                s = s + term(r, j)
            parts[k] = s
            if k == first + (z >> 8) - 1:
                s = 0.0
                for i in range(first, k + 1):
                    s = s + parts[i]
                sums[r] = (s, z >> 8 > 1 or z & 0xFF > 1)
    return sums


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_kernel_tables_give_the_plain_step(seed):
    """The kernel's tables, summed as its two phases sum them, give
    `_em_step`'s alphas over a few iterations (float64, rtol 1e-12:
    only a long row's chunks associate apart); every transcript in a
    class is written, and only those."""
    eq, eff, total = _problem(seed)
    T = len(eff) + 4
    p = port_em._Problem(eq, eff, T, torch.device("cpu"), torch.float64)
    tb = {k: v.numpy() for k, v in port_em.kernel_tables(p).items()}
    np.testing.assert_array_equal(tb["empty"],
                                  np.bincount(eq.members, minlength=T) == 0)
    sing = p.sing_out.numpy()
    alpha = np.where(tb["empty"], 0.0, total / (T - tb["empty"].sum()))
    for _ in range(5):
        want = port_em._em_step(p, torch.as_tensor(alpha)).numpy()
        cls = _phase_by_chunks(tb["crec"], lambda r, j: alpha[
            tb["members"][j]] * tb["w"][j])
        scale = np.zeros(eq.num_classes)
        for c, (d, several) in cls.items():
            scale[c] = tb["counts"][c] / d if several and d > 0 else 0.0
        txp = _phase_by_chunks(tb["trec"], lambda r, j: (
            alpha[r] * tb["tw"][j]) * scale[tb["tcls"][j]])
        assert sorted(txp) == np.flatnonzero(~tb["empty"]).tolist()
        alpha = np.zeros(T)
        for t, (s, _) in txp.items():
            alpha[t] = s + sing[t]
        np.testing.assert_allclose(alpha, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("device,use_vbem,kernel", [
    ("cpu", False, False), ("cpu", True, False), ("cuda", False, True),
    ("cuda", True, False), ("cuda:0", False, True)])
def test_run_em_path_choice(device, use_vbem, kernel):
    """The EM on a CUDA device iterates in csrc/em.cu; the VBEM, and any
    solve on the CPU, in the torch loop."""
    assert port_em.uses_kernel(torch.device(device), use_vbem) is kernel


@pytest.mark.parametrize("use_vbem", [False, True])
def test_cpu_solve_takes_the_torch_loop(use_vbem, monkeypatch):
    """On the CPU `run_em` launches nothing and every step goes through
    the plain step functions."""
    eq, eff, total = _problem(4)
    steps = []
    name = "_vbem_step" if use_vbem else "_em_step"
    orig = getattr(port_em, name)
    monkeypatch.setattr(port_em, name,
                        lambda *a: steps.append(1) or orig(*a))
    launches = trace.counter("launch.em_solve")
    got = run_em(eq, eff, total, len(eff), device="cpu", use_vbem=use_vbem)
    assert trace.counter("launch.em_solve") == launches
    assert len(steps) == got.num_iterations > 0


def _singletons(num_txps: int = 40):
    rng = np.random.default_rng(7)
    eq = EqClasses.from_items([((t,), int(rng.integers(1, 500)))
                               for t in range(0, num_txps, 2)])
    return eq, rng.uniform(20.0, 3000.0, num_txps), float(eq.total_count())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the EM kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", [
    "seed1", "seed2", "cap", "continue", "min_iter", "singletons",
    "float32"])
def test_em_kernel_matches_plain_loop(card, case):
    """On the card: `run_em` through csrc/em.cu against the torch loop on
    the CPU, on the same problem: the same iteration count and
    convergence, alphas within rtol 1e-9 in float64 (the kernel adds a
    long row's chunks apart) and 1e-5 in float32, max_rel_diff within
    rtol 1e-6 in float64; in float32 within 8 float32 epsilons of
    1 + itself: it is a ratio of two alphas' small difference, which one
    unit in the last place of an alpha moves by about an epsilon (up to
    two epsilons apart on the H100, a third of the value where it is near
    1e-7).  One launch a solve."""
    seed = {"seed2": 2, "cap": 3}.get(case, 1)
    eq, eff, total = _singletons() if case == "singletons" \
        else _problem(seed)
    kw = dict(rel_diff_tol=0.01, max_iter=10000, min_iter=50)
    if case == "cap":
        kw.update(min_iter=5, max_iter=7, rel_diff_tol=1e-12)
    if case == "min_iter":
        kw.update(min_iter=200)  # seed 1 converges at iteration 90
    if case == "continue":
        # a bias segment: from the raw alphas of 50 iterations, 0 to 450
        first = run_em(eq, eff, total, len(eff), device="cpu", min_iter=50,
                       max_iter=50)
        kw.update(min_iter=0, max_iter=450, alpha0=first.alphas_raw)
    if case == "float32":
        kw.update(dtype=torch.float32)
    want = run_em(eq, eff, total, len(eff), device="cpu", **kw)
    launches = trace.counter("launch.em_solve")
    got = run_em(eq, eff, total, len(eff), device=card, **kw)
    assert trace.counter("launch.em_solve") == launches + 1
    assert got.num_iterations == want.num_iterations
    assert got.converged == want.converged
    if case == "cap":
        assert got.num_iterations == 7 and not got.converged
    if case == "min_iter":
        assert got.num_iterations == 200 and got.converged
    rtol = 1e-5 if case == "float32" else 1e-9
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.alphas_raw, want.alphas_raw, rtol=rtol,
                               atol=0)
    if case == "float32":
        assert abs(got.max_rel_diff - want.max_rel_diff) \
            <= 8 * np.finfo(np.float32).eps * (1 + want.max_rel_diff)
    else:
        np.testing.assert_allclose(got.max_rel_diff, want.max_rel_diff,
                                   rtol=1e-6)
