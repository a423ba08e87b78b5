"""Fragment-length distribution and effective-length machinery.

Numerical ports of:
  * getNormalFragLengthDist / getNormalFragLengthCounts
    (reference src/SailfishQuantify.cpp:648-704)
  * correctionFactorsFromCounts (:769-807)
  * computeSmoothedEffectiveLengths (:809-838)
  * computeEmpiricalEffectiveLengths — eXpress-style convolution (:717-767)
  * EmpiricalDistribution (src/EmpiricalDistribution.cpp:29-144)

All are vectorized (cumsums) — these run once per quant and are cheap;
they stay on host in float64 for exactness.
"""

from __future__ import annotations

import numpy as np


def normal_fragment_length_dist(
    mean: float, sd: float, max_frag_len: int
) -> np.ndarray:
    """Smoothed correction factors under a normal FLD prior.

    Port of getNormalFragLengthDist (src/SailfishQuantify.cpp:648-673):
    correctionFactors[i] = (sum_{j<=i} j*pdf(j)) / (sum_{j<=i} pdf(j)),
    i.e. the conditional mean fragment length given fragLen <= i.
    """
    i = np.arange(max_frag_len, dtype=np.float64)
    x = (i - mean) / sd
    d = np.exp(-0.5 * x * x) / sd
    cum_mass = np.cumsum(i * d)
    cum_density = np.cumsum(d)
    out = np.zeros(max_frag_len, dtype=np.float64)
    nz = cum_density > 0
    out[nz] = cum_mass[nz] / cum_density[nz]
    return out


def normal_fragment_length_counts(
    mean: float, sd: float, max_frag_len: int, total_count: int
) -> np.ndarray:
    """Integer FLD histogram realized from the normal prior.

    Port of getNormalFragLengthCounts (src/SailfishQuantify.cpp:675-704).
    """
    i = np.arange(max_frag_len, dtype=np.float64)
    x = (i - mean) / sd
    d = np.exp(-0.5 * x * x) / sd
    total_mass = d.sum()
    if total_mass <= 0:
        return np.zeros(max_frag_len, dtype=np.int32)
    # C++ std::round rounds half away from zero; values here are positive
    # so floor(x + 0.5) matches.
    return np.floor(d * total_count / total_mass + 0.5).astype(np.int32)


def correction_factors_from_counts(fl_counts: np.ndarray) -> np.ndarray:
    """Smoothed correction factors from the observed FLD histogram.

    Port of correctionFactorsFromCounts (src/SailfishQuantify.cpp:769-807):
    running conditional mean over the histogram; bins with zero cumulative
    multiplicity keep factor 0.  Index 0's factor is 0 (loop starts at 1).
    """
    max_len = len(fl_counts)
    v = np.asarray(fl_counts, dtype=np.float64)
    i = np.arange(max_len, dtype=np.float64)
    vals = np.cumsum(v * i)
    mult = np.cumsum(v)
    out = np.zeros(max_len, dtype=np.float64)
    nz = mult > 0
    out[nz] = vals[nz] / mult[nz]
    out[0] = 0.0  # reference loop starts at i=1; factor[0] stays 0
    return out


def smoothed_effective_lengths(
    ref_lens: np.ndarray, correction_factors: np.ndarray
) -> np.ndarray:
    """effLen = refLen - cf[min(refLen, maxLen-1)] + 1, clamped to refLen
    when < 1.  Port of computeSmoothedEffectiveLengths
    (src/SailfishQuantify.cpp:809-838)."""
    ref_lens = np.asarray(ref_lens, dtype=np.int64)
    max_len = len(correction_factors)
    idx = np.where(ref_lens >= max_len, max_len - 1, ref_lens)
    cf = correction_factors[idx]
    eff = ref_lens.astype(np.float64) - cf + 1.0
    return np.where(eff < 1.0, ref_lens.astype(np.float64), eff)


class EmpiricalDistribution:
    """Binned empirical pmf/cdf with the reference's quirks.

    Port of src/EmpiricalDistribution.cpp:29-144 (itself adapted from
    isolator): the support is truncated at the value where the cumulative
    probability first exceeds 1 - 1e-6, the pmf is renormalized over the
    retained support, and pdf/cdf query x >= support as 0 / 1.
    """

    def __init__(self, vals: np.ndarray, lens: np.ndarray):
        vals = np.asarray(vals, dtype=np.int64)
        lens = np.asarray(lens, dtype=np.int64)
        assert len(vals) == len(lens)
        self.min_val = int(vals.min()) if len(vals) else 0
        self.max_val = int(vals.max()) if len(vals) else 0
        valsum = float(lens.sum())

        # truncation: keep entries up to (and including) the first whose
        # cumulative fraction exceeds 1 - 1e-6
        cum = np.cumsum(lens) / valsum if valsum > 0 else np.zeros(len(lens))
        over = np.nonzero(cum > 1.0 - 1e-6)[0]
        lastval = int(over[0]) if len(over) else len(vals)
        # reference: maxval = vals[lastval] (the breaking entry), pdf has
        # size maxval (exclusive), renormalized over entries < lastval
        if lastval < len(vals):
            maxval = int(vals[lastval])
        else:
            maxval = int(vals[-1]) if len(vals) else 1
        maxval = max(maxval, 1)
        norm = float(lens[:lastval].sum())
        pdf = np.zeros(maxval, dtype=np.float64)
        in_range = vals[:lastval] < maxval
        if norm > 0:
            pdf[vals[:lastval][in_range]] = lens[:lastval][in_range] / norm
        self.pdfvals = pdf
        self.cdfvals = np.cumsum(pdf)

        # weighted median (reference two-pointer walk)
        if len(vals):
            i, j = 0, len(vals) - 1
            u, v = int(lens[0]), int(lens[-1])
            while i < j:
                if u <= v:
                    v -= u
                    i += 1
                    u = int(lens[i])
                else:
                    u -= v
                    j -= 1
                    v = int(lens[j])
            self.med = float(vals[i])
        else:
            self.med = float("nan")

    def pdf(self, x):
        x = np.asarray(x, dtype=np.int64)
        out = np.where(
            (x >= 0) & (x < len(self.pdfvals)),
            self.pdfvals[np.clip(x, 0, len(self.pdfvals) - 1)],
            0.0,
        )
        return out if out.ndim else float(out)

    def cdf(self, x):
        x = np.asarray(x, dtype=np.int64)
        out = np.where(
            (x >= 0) & (x < len(self.cdfvals)),
            self.cdfvals[np.clip(x, 0, len(self.cdfvals) - 1)],
            1.0,
        )
        return out if out.ndim else float(out)

    def median(self) -> float:
        return self.med

    def realize(self, rng: np.random.Generator, num_samp: int = 10000) -> np.ndarray:
        """Draw num_samp samples, returned as a histogram over [0, max_val]
        (port of EmpiricalDistribution::realize, used for aux/fld.gz)."""
        size = self.max_val + 1
        padded = np.zeros(size, dtype=np.float64)
        upto = min(size, len(self.pdfvals))
        padded[:upto] = self.pdfvals[:upto]
        if padded.sum() <= 0:
            return np.zeros(size, dtype=np.int32)
        p = padded / padded.sum()
        draws = rng.choice(size, size=num_samp, p=p)
        return np.bincount(draws, minlength=size).astype(np.int32)


def unsmoothed_effective_lengths(
    ref_lens: np.ndarray, emp: EmpiricalDistribution
) -> np.ndarray:
    """eXpress-style convolution: effLen = sum_l pdf(l) * (refLen - l + 1)
    over the distribution support; transcripts no longer than the median
    (or an invalid support) keep refLen.

    Port of computeEmpiricalEffectiveLengths
    (src/SailfishQuantify.cpp:717-767).
    """
    ref_lens = np.asarray(ref_lens, dtype=np.int64)
    out = ref_lens.astype(np.float64).copy()
    valid = emp.max_val > emp.min_val
    if not valid:
        return out
    lvals = np.arange(emp.min_val, emp.max_val + 1, dtype=np.int64)
    pdfs = emp.pdf(lvals)
    for t, rl in enumerate(ref_lens):
        if rl <= emp.median():
            continue
        m = lvals <= rl
        out[t] = float((pdfs[m] * (rl - lvals[m] + 1.0)).sum())
    return out


def effective_lengths_from_fld(
    ref_lens: np.ndarray,
    fl_counts: np.ndarray,
    *,
    num_observed: int,
    num_required: int,
    fld_mean: float,
    fld_sd: float,
    max_frag_len: int,
    use_unsmoothed: bool = False,
    paired_end: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """End-of-mapping effective-length computation.

    Mirrors the decision tree at src/SailfishQuantify.cpp:961-992 (PE) and
    :1035-1043 (SE).  Returns (effective_lengths, fld_histogram) where the
    histogram is the one recorded in the experiment (observed counts, or
    the realized normal prior when observations were insufficient).
    """
    if (not paired_end) or num_observed < num_required:
        fld = normal_fragment_length_counts(
            fld_mean, fld_sd, max_frag_len, total_count=num_required
        )
        cf = normal_fragment_length_dist(fld_mean, fld_sd, max_frag_len)
        return smoothed_effective_lengths(ref_lens, cf), fld
    fld = np.asarray(fl_counts, dtype=np.int32)
    if use_unsmoothed:
        nz = np.nonzero(fl_counts)[0]
        emp = EmpiricalDistribution(nz, fl_counts[nz])
        return unsmoothed_effective_lengths(ref_lens, emp), fld
    cf = correction_factors_from_counts(fl_counts)
    return smoothed_effective_lengths(ref_lens, cf), fld
