"""Collapsed EM / VBEM over equivalence classes.

Counterpart of sailfish_tpu/infer/em.py (`_em_step`, `_vbem_step`,
`_optimize_jit`, `class_weights`, `run_em`), same semantics (reference
src/CollapsedEMOptimizer.cpp): per-class weights 1/effLen normalized
within the class; active transcripts start at totalMapped / numActive;
singleton classes give their whole count to their member; classes whose
denominator is <= the float64 denormal minimum contribute nothing;
iterate while it < min_iter or (it < max_iter and not converged), where
converged means |alpha - alpha'| / alpha' <= tol for every alpha' >
1e-2; truncate alphas <= 1e-8 (EM) or 0.01 + 1e-8 (VBEM) to 0.

Each iteration is two `index_add_` scatters over the CSR membership in
float64.  On CUDA those are atomics, so their summation order (and the
last bits of the sums) differ from the CPU's.  The convergence test
needs a host sync, which is taken only once `min_iter` is reached.

The steps take any number of leading axes: one alpha vector (T,) is the
main EM; (R, T) with per-replicate class counts (R, C) is the stacked
bootstrap EM of infer/bootstrap.py.  `run_em` also continues from given
alphas over a `min_iter`/`max_iter` segment, which is how
stats/bias.py `run_em_with_bias` recomputes effective lengths between
segments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_device
from ..eqclass.classes import EqClasses

_DENORM_MIN64 = 4.9406564584124654e-324
_ALPHA_CHECK_CUTOFF = 1e-2


@dataclasses.dataclass
class EMResult:
    alphas: np.ndarray          # estimated counts per transcript (truncated)
    num_iterations: int
    max_rel_diff: float
    converged: bool
    alphas_raw: np.ndarray | None = None    # the same before truncation


def truncation_cutoff(use_vbem: bool) -> float:
    """Final alphas at or below this become 0."""
    return (0.01 + 1e-8) if use_vbem else 1e-8


def class_weights(eq: EqClasses, eff_lens: np.ndarray) -> np.ndarray:
    """Per-member weights 1/effLen normalized within each class."""
    eff = np.maximum(np.asarray(eff_lens, dtype=np.float64), 1.0)
    inv = 1.0 / eff[eq.members]
    com = eq.class_of_member()
    denom = np.bincount(com, weights=inv, minlength=eq.num_classes)
    return inv / denom[com]


class _Problem:
    """The EM's device-resident inputs.  `counts` replaces the classes'
    own counts, (C,) or stacked (R, C)."""

    def __init__(self, eq: EqClasses, eff_lens, num_txps: int,
                 device: torch.device, dtype: torch.dtype, counts=None):
        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=device)

        self.num_txps = num_txps
        self.members = up(eq.members, torch.int64)
        self.com = up(eq.class_of_member(), torch.int64)
        self.counts = up(eq.counts, dtype) if counts is None else counts
        self.weights = up(class_weights(eq, eff_lens), dtype)
        self.singleton = up(eq.class_sizes() == 1, torch.bool)
        self.min_w = (_DENORM_MIN64 if dtype == torch.float64
                      else float(np.finfo(np.float32).tiny))
        # singleton classes add the same amount every iteration
        sing = torch.where(self.singleton, self.counts, 0.0)
        self.sing_out = self._scatter(sing[..., self.com], self.members,
                                      num_txps)

    @staticmethod
    def _scatter(src, index, size: int):
        """Sum `src` (..., M) into (..., size) along the last axis."""
        out = src.new_zeros(src.shape[:-1] + (size,))
        return out.index_add_(src.dim() - 1, index, src)

    def distribute(self, theta):
        """sum over multi-member classes of count * theta_t w_t / denom,
        plus the singleton classes' counts; theta (..., T)."""
        av = theta[..., self.members] * self.weights
        denom = self._scatter(av, self.com, self.singleton.shape[0])
        ok = (denom > self.min_w) & ~self.singleton
        scale = torch.where(ok, self.counts / torch.where(ok, denom, 1.0),
                            0.0)
        return (self._scatter(av * scale[..., self.com], self.members,
                              self.num_txps) + self.sing_out)


def _em_step(p: _Problem, alpha):
    return p.distribute(alpha)


def _vbem_step(p: _Problem, alpha, prior_alpha: float = 0.01):
    log_norm = torch.special.digamma(alpha.sum(dim=-1, keepdim=True))
    pos = (alpha > _DENORM_MIN64 if alpha.dtype == torch.float64
           else alpha > 0.0)
    exp_theta = torch.where(
        pos,
        torch.exp(torch.special.digamma(alpha.clamp(min=1e-300)) - log_norm),
        0.0)
    return prior_alpha + p.distribute(exp_theta)


def run_em(eq: EqClasses, eff_lens: np.ndarray, total_mapped: float,
           num_txps: int, *, device, use_vbem: bool = False,
           rel_diff_tol: float = 0.01, max_iter: int = 10000,
           min_iter: int = 50, dtype: torch.dtype = torch.float64,
           alpha0: np.ndarray | None = None) -> EMResult:
    """Run the collapsed EM/VBEM on `device` to convergence and
    truncate.  `alpha0` continues from given (untruncated) alphas
    instead of the uniform active init; `total_mapped` is unused
    then."""
    dev = as_device(device)
    p = _Problem(eq, eff_lens, num_txps, dev, dtype)
    active = np.zeros(num_txps, dtype=bool)
    active[np.unique(eq.members)] = True
    num_active = int(active.sum())
    if num_active == 0:
        raise RuntimeError("no transcripts are expressed; mapping failed?")
    if alpha0 is None:
        alpha0 = np.where(active, total_mapped / num_active, 0.0)
    alpha = torch.as_tensor(np.asarray(alpha0), dtype=dtype, device=dev)
    step = _vbem_step if use_vbem else _em_step
    prev = None
    it = 0
    converged = False
    while it < min_iter or (it < max_iter and not converged):
        nxt = step(p, alpha)
        it += 1
        prev, alpha = alpha, nxt
        if it >= min_iter:
            check = alpha > _ALPHA_CHECK_CUTOFF
            rel = (prev - alpha).abs() / torch.where(check, alpha, 1.0)
            converged = bool(torch.where(check, rel <= rel_diff_tol,
                                         True).all())
    max_rel = float("-inf")
    if prev is not None:
        check = alpha > _ALPHA_CHECK_CUTOFF
        if bool(check.any()):
            rel = (prev - alpha).abs() / torch.where(check, alpha, 1.0)
            max_rel = float(rel[check].max())
    raw = alpha.cpu().numpy().astype(np.float64)
    alphas = raw.copy()
    alphas[alphas <= truncation_cutoff(use_vbem)] = 0.0
    return EMResult(alphas=alphas, num_iterations=it, max_rel_diff=max_rel,
                    converged=converged, alphas_raw=raw)
