"""Bootstrap replicates of the collapsed EM.

Counterpart of sailfish_tpu/infer/bootstrap.py.  Semantics from
CollapsedEMOptimizer::gatherBootstraps / doBootstrap (reference
src/CollapsedEMOptimizer.cpp:438-709):

  * per replicate, class counts are redrawn Multinomial(totalCount,
    p_c = origCount_c / totalCount)
  * the EM (or VBEM) re-runs to convergence with the same class weights
    and the uniform active-transcript init
  * the bootstrap convergence check reads `alphas[i] > 1e-2`, the
    previous iterate — unlike the main path, which checks alphasPrime
    (:498-505)
  * final alphas truncated at 1e-8 (VBEM: 0.01 + 1e-8) and emitted as
    raw doubles

The replicates of a round run stacked, (R, T) alphas over (R, C) counts
through the steps of infer/em.py; a converged replicate freezes, so each
stops at exactly its own iteration count, like the reference's serial
loops.  The multinomial is drawn by inverting the class-count CDF at
totalCount uniforms from an explicit `torch.Generator` on the run's
device, a chunk of uniforms at a time.  Torch's random stream is not the
JAX package's: replicates agree in distribution, not draw by draw.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..device import as_device
from ..eqclass.classes import EqClasses
from .em import _Problem, _em_step, _vbem_step, truncation_cutoff

_DRAW_CHUNK = 1 << 24


def multinomial_counts(gen: torch.Generator, cdf: torch.Tensor,
                       num_draws: int, chunk: int = _DRAW_CHUNK):
    """counts ~ Multinomial(num_draws, diff(cdf)) by inverse CDF, at most
    `chunk` uniforms in memory at once; (C,) in cdf's dtype."""
    C = cdf.shape[0]
    counts = torch.zeros(C, dtype=torch.int64, device=cdf.device)
    for s in range(0, num_draws, chunk):
        u = torch.rand(min(chunk, num_draws - s), generator=gen,
                       dtype=cdf.dtype, device=cdf.device)
        bins = torch.searchsorted(cdf, u, right=True).clamp(max=C - 1)
        counts += torch.bincount(bins, minlength=C)
    return counts.to(cdf.dtype)


def bootstrap_em(p: _Problem, alpha0: torch.Tensor, *, use_vbem: bool,
                 max_iter: int, rel_diff_tol: float):
    """The stacked EM over `p.counts` (R, C) from `alpha0` (T,); returns
    the untruncated alphas (R, T) and each replicate's iterations (R,)."""
    step = _vbem_step if use_vbem else _em_step
    R = p.counts.shape[0]
    alpha = alpha0.expand(R, -1).clone()
    done = torch.zeros(R, dtype=torch.bool, device=alpha.device)
    iters = torch.zeros(R, dtype=torch.int64, device=alpha.device)
    it = 0
    while it < max_iter and not bool(done.all()):
        nxt = step(p, alpha)
        # the bootstrap convergence test reads the old alphas (:498-505)
        check = alpha > 1e-2
        rel = (alpha - nxt).abs() / torch.where(check, nxt.abs(), 1.0)
        conv = torch.where(check, rel <= rel_diff_tol, True).all(dim=1)
        alpha = torch.where(done[:, None], alpha, nxt)
        iters += ~done
        done = done | conv
        it += 1
    return alpha, iters


def run_bootstraps(eq: EqClasses, eff_lens: np.ndarray, num_txps: int, *,
                   device, num_bootstraps: int, use_vbem: bool = False,
                   rel_diff_tol: float = 0.01, max_iter: int = 10000,
                   seed: int = 0, dtype: torch.dtype = torch.float64,
                   replicates_per_round: int = 16) -> Iterator[np.ndarray]:
    """Yield per-replicate truncated alpha vectors (float64)."""
    dev = as_device(device)
    total = eq.total_count()
    active = np.zeros(num_txps, dtype=bool)
    active[np.unique(eq.members)] = True
    alpha0 = torch.as_tensor(np.where(active, total / active.sum(), 0.0),
                             dtype=dtype, device=dev)
    cdf = torch.as_tensor(np.cumsum(eq.counts.astype(np.float64) / total),
                          dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    done = 0
    while done < num_bootstraps:
        r = min(replicates_per_round, num_bootstraps - done)
        counts_r = torch.stack(
            [multinomial_counts(gen, cdf, total) for _ in range(r)])
        p = _Problem(eq, eff_lens, num_txps, dev, dtype, counts=counts_r)
        alphas, _ = bootstrap_em(p, alpha0, use_vbem=use_vbem, max_iter=max_iter,
                                 rel_diff_tol=rel_diff_tol)
        alphas = alphas.cpu().numpy().astype(np.float64)
        alphas[alphas <= truncation_cutoff(use_vbem)] = 0.0
        yield from alphas
        done += r
