"""Plain reference of the collapsed EM, in PyTorch.

The semantics of the port's `infer/em.py` and of the reference's
src/CollapsedEMOptimizer.cpp, written again: per-class weights 1/effLen
normalised within the class; active transcripts start at
total / active; a singleton class gives its count to its member; a
class whose denominator is at most the smallest positive number of the
dtype gives nothing; iterate while it < min_iter or (it < max_iter and
not converged), converged when |a - a'| / a' <= tol for every a' > 0.01;
alphas at or below 1e-8 become 0.

Sums are segment sums over members sorted by class and by transcript
(`torch.segment_reduce`), so the result is the same on every run, where
the port's `index_add_` uses atomics on the card.  `dtype` float32 is
the control: the nearest precision below the configuration's float64.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHA_CHECK_CUTOFF = 1e-2
TRUNCATE = 1e-8


def solve(members: np.ndarray, offsets: np.ndarray, counts: np.ndarray,
          eff_lens: np.ndarray, total: float, num_txps: int, *, device,
          dtype=torch.float64, tol: float = 0.01, min_iter: int = 50,
          max_iter: int = 10000):
    """(alphas, iterations) of the EM on CSR classes."""
    dev = torch.device(device)
    sizes = np.diff(offsets)
    com = np.repeat(np.arange(len(sizes)), sizes)

    def up(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev, dtype=dt)

    mem = up(members.astype(np.int64))
    csz = up(sizes.astype(np.int64))
    com_t = up(com.astype(np.int64))
    order = up(np.argsort(members, kind="stable").astype(np.int64))
    tsz = up(np.bincount(members, minlength=num_txps).astype(np.int64))
    eff = np.maximum(np.asarray(eff_lens, np.float64), 1.0)
    inv = 1.0 / eff[members]
    w = inv / np.add.reduceat(inv, offsets[:-1])[com]
    w = up(w, dtype)
    cnt = up(counts, dtype)
    single = up(sizes == 1)
    tiny = torch.finfo(dtype).tiny if dtype == torch.float32 else 5e-324

    def by_class(v):
        return torch.segment_reduce(v, "sum", lengths=csz)

    def by_txp(v):
        return torch.segment_reduce(v[order], "sum", lengths=tsz)

    sing_out = by_txp(torch.where(single, cnt, 0.0)[com_t])

    def step(theta):
        av = theta[mem] * w
        den = by_class(av)
        ok = (den > tiny) & ~single
        scale = torch.where(ok, cnt / torch.where(ok, den, 1.0), 0.0)
        return by_txp(av * scale[com_t]) + sing_out

    active = np.zeros(num_txps, bool)
    active[members] = True
    alpha = up(np.where(active, total / active.sum(), 0.0), dtype)
    it, converged = 0, False
    while it < min_iter or (it < max_iter and not converged):
        prev, alpha = alpha, step(alpha)
        it += 1
        if it >= min_iter:
            check = alpha > ALPHA_CHECK_CUTOFF
            rel = (prev - alpha).abs() / torch.where(check, alpha, 1.0)
            converged = bool(torch.where(check, rel <= tol, True).all())
    out = alpha.double().cpu().numpy()
    out[out <= TRUNCATE] = 0.0
    return out, it
