"""Sequential-scan collapsed Gibbs — a faithful host port of the
reference chain (src/CollapsedGibbsSampler.cpp:35-186) used to validate
the blocked device sampler (infer/gibbs.py) statistically.

A copy of sailfish_tpu/refimpl/gibbs.py with this package's
`class_weights`; with one numpy seed both give the same samples.

Ported quirks, deliberately:
  * initCountMap_ (:35-94): multinomial split of each class's count by
    (priorAlpha + EM-mass_t) * aux_t; a class whose denom underflows
    denorm_min keeps ZERO allocation (its mass vanishes).
  * sampleRound_ (:96-186): classes are resampled SEQUENTIALLY — class
    j's conditional sees the txp counts already updated by classes < j
    in the same round (the coupling the blocked device chain replaces
    with snapshot conditioning).
  * The per-class denominator is accumulated INSIDE the member
    subtraction loop (member i sees members <= i subtracted), while the
    multinomial probabilities are computed after ALL members are
    subtracted — for labels with duplicate transcript ids (orphans)
    these differ and the probabilities need not sum to 1.
  * MultinomialSampler (include/MultinomialSampler.hpp): inverse-CDF
    over the RAW cumulative probabilities (no renormalization); a draw
    u beyond the final cumulative value increments nothing and is
    silently dropped.

This implementation is O(samples * rounds * classes) host Python — a
validator, not a production path.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..eqclass.classes import EqClasses
from ..infer.em import class_weights

_PRIOR = 1e-8           # priorAlpha (:215)
_MIN_W = 5e-324         # std::numeric_limits<double>::denorm_min


def _msamp(rng, n: int, probs: np.ndarray) -> np.ndarray:
    """MultinomialSampler::operator(): n inverse-CDF draws against the
    raw cumulative distribution; draws beyond the last edge drop."""
    k = len(probs)
    z = np.zeros(k + 1)
    np.cumsum(probs, out=z[1:])
    u = rng.random(n)
    # bin i catches z[i] < u <= z[i+1]
    idx = np.searchsorted(z, u, side="left") - 1
    idx = idx[(idx >= 0) & (idx < k)]
    out = np.zeros(k, dtype=np.int64)
    np.add.at(out, idx, 1)
    return out


def run_gibbs_sequential(
    eq: EqClasses,
    eff_lens: np.ndarray,
    em_alphas: np.ndarray,
    num_txps: int,
    *,
    num_samples: int,
    total_mapped: float,
    seed: int = 0,
    inner_rounds: int = 10,
) -> Iterator[np.ndarray]:
    """Yield integer per-transcript count vectors, one per emitted
    sample (inner_rounds thinning like the reference's 10)."""
    weights = class_weights(eq, eff_lens)
    rng = np.random.default_rng(seed)
    offsets = eq.offsets
    members = eq.members
    counts = eq.counts
    C = eq.num_classes

    count_m = np.zeros(eq.num_members, np.int64)
    txp = np.zeros(num_txps, np.int64)

    s = float(em_alphas.sum())
    mass = (em_alphas / s * total_mapped) if s > 0 else em_alphas

    # ---- initCountMap_ ----
    for c in range(C):
        o0, o1 = int(offsets[c]), int(offsets[c + 1])
        tids = members[o0:o1]
        if o1 - o0 > 1:
            p = (_PRIOR + mass[tids]) * weights[o0:o1]
            denom = float(p.sum())
            if denom > _MIN_W:
                count_m[o0:o1] = _msamp(rng, int(counts[c]), p / denom)
        else:
            count_m[o0] = counts[c]
        np.add.at(txp, tids, count_m[o0:o1])

    # ---- sampleRound_ x inner_rounds per emitted sample ----
    for _ in range(num_samples):
        for _r in range(inner_rounds):
            for c in range(C):
                frac = rng.uniform(0.25, 0.75)  # drawn per class (:113)
                o0, o1 = int(offsets[c]), int(offsets[c + 1])
                gs = o1 - o0
                if gs <= 1:
                    continue
                tids = members[o0:o1]
                aux = weights[o0:o1]
                resamp = np.rint(frac * count_m[o0:o1]).astype(np.int64)
                n = int(resamp.sum())
                denom = 0.0
                for i in range(gs):
                    txp[tids[i]] -= resamp[i]
                    count_m[o0 + i] -= resamp[i]
                    denom += (_PRIOR + txp[tids[i]]) * aux[i]
                if denom > _MIN_W:
                    probs = (_PRIOR + txp[tids]) * aux / denom
                    draws = _msamp(rng, n, probs)
                    count_m[o0:o1] += draws
                    np.add.at(txp, tids, draws)
                else:  # put the resampled mass back unchanged (:166-173)
                    count_m[o0:o1] += resamp
                    np.add.at(txp, tids, resamp)
        yield txp.astype(np.int32).copy()
