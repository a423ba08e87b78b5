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

On a CUDA device the EM's iterations run in one launch of
csrc/em.cu (`_iterate_cuda`): the step, the convergence test and the
stop rule on the card, and one host wait a solve.  Elsewhere, and for
the VBEM, they run as a torch loop (`_iterate`, the kernel's plain
version): each step two `index_add_` scatters over the CSR membership,
the convergence test a host sync an iteration once `min_iter` is
reached.  A solve is the span `em.solve` (trace.py), split into
`em.upload`, `em.iterate` and `em.pull`; it counts `em.iterations` and
`em.syncs`, the host's waits on the device: each upload, each
convergence test (the kernel's one wait on its result), the final
pulls.  `launch.em_solve` counts the kernel's launches.

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

from .. import trace
from ..device import as_device
from ..eqclass.classes import EqClasses

_DENORM_MIN64 = 4.9406564584124654e-324
_ALPHA_CHECK_CUTOFF = 1e-2
# csrc/em.cu cuts each row (a class's members, a transcript's) into
# chunks of at most this many entries (its kChunk, which it checks)
EM_CHUNK = 8


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
    own counts, (C,) or stacked (R, C).  `uploads` counts the copies
    from the host."""

    def __init__(self, eq: EqClasses, eff_lens, num_txps: int,
                 device: torch.device, dtype: torch.dtype, counts=None):
        self.uploads = 0

        def up(a, dt):
            self.uploads += 1
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


def _iterate(p: _Problem, alpha, step, *, min_iter: int, max_iter: int,
             rel_diff_tol: float):
    """The EM's iterations as a torch loop from `alpha`: while it <
    min_iter or (it < max_iter and not converged), converged meaning
    |alpha - alpha'| / alpha' <= rel_diff_tol for every alpha' > 1e-2,
    tested from it >= min_iter on.  Returns (previous alphas or None,
    alphas, iterations, converged, host waits)."""
    prev = None
    it = 0
    converged = False
    waits = 0
    while it < min_iter or (it < max_iter and not converged):
        nxt = step(p, alpha)
        it += 1
        prev, alpha = alpha, nxt
        if it >= min_iter:
            check = alpha > _ALPHA_CHECK_CUTOFF
            rel = (prev - alpha).abs() / torch.where(check, alpha, 1.0)
            converged = bool(torch.where(check, rel <= rel_diff_tol,
                                         True).all())
            waits += 1
    return prev, alpha, it, converged, waits


def uses_kernel(device: torch.device, use_vbem: bool) -> bool:
    """Whether run_em iterates in csrc/em.cu: the EM on a CUDA device.
    The VBEM and every other device take the torch loop."""
    return device.type == "cuda" and not use_vbem


def transcript_major(members: torch.Tensor, num_txps: int):
    """The members' order by transcript, stable (a transcript's members
    keep their class order), and each transcript's offsets into it,
    (num_txps + 1,): transcript t's members are
    order[offsets[t]:offsets[t + 1]]."""
    by_txp, order = torch.sort(members, stable=True)
    offsets = torch.searchsorted(
        by_txp, torch.arange(num_txps + 1, dtype=members.dtype,
                             device=members.device))
    return order, offsets


def chunk_table(offsets: torch.Tensor, entries: int) -> torch.Tensor:
    """The chunk records csrc/em.cu reads for the rows of a CSR
    (`offsets`, R + 1, over `entries` entries, offsets[-1] as the caller
    knows it without reading the device): (R + ceil(entries / EM_CHUNK),
    4) int32, each (row, first entry, entries | the row's chunks << 8,
    the row's first chunk) for a chunk of at most EM_CHUNK of a row's
    entries, a row's chunks in order and none for an empty row; the
    records past the last chunk have row -1."""
    chunk = EM_CHUNK
    dev = offsets.device
    R = offsets.numel() - 1
    nch = (offsets[1:] - offsets[:-1] + chunk - 1) // chunk
    first = torch.cumsum(nch, 0) - nch
    K = R + (entries + chunk - 1) // chunk
    # each chunk's row: a row's index at its first chunk, carried forward
    # (an empty row's first chunk is that of the next row, the larger)
    row = torch.zeros(K, dtype=torch.int64, device=dev).scatter_reduce_(
        0, first, torch.arange(R, device=dev), "amax")
    row = torch.cummax(row, 0).values
    i = torch.arange(K, device=dev) - first[row]
    j0 = offsets[row] + i * chunk
    n = torch.clamp(offsets[row + 1] - j0, 0, chunk)
    return torch.stack((torch.where(i < nch[row], row, -1), j0,
                        n | (nch[row] << 8), first[row]), 1).to(torch.int32)


def kernel_tables(p: _Problem) -> dict:
    """The tables csrc/em.cu reads, built on the problem's device without
    a host sync: `crec` (chunk records over the members in class order),
    `members` (int32) and `w` in that order, `counts` a class; `trec`
    over the members in transcript order, `tcls` (int32) and `tw` in
    that order; `empty`, the transcripts in no class.  The classes are
    renumbered by their first member, so that the classes of a
    transcript lie near each other, as the transcripts of a class do:
    the gathers of both phases share sectors.  No sum changes its order:
    a class keeps its members' order and a transcript its classes'."""
    C, T, M = p.singleton.shape[0], p.num_txps, p.members.shape[0]
    span = torch.arange(C + 1, device=p.members.device)
    by_first = torch.sort(p.members[torch.searchsorted(p.com, span[:-1])],
                          stable=True).indices
    rank = torch.empty_like(by_first)
    rank[by_first] = span[:-1]
    com = rank[p.com]
    corder = torch.sort(com, stable=True).indices
    order, toff = transcript_major(p.members, T)
    i32 = torch.int32
    return dict(crec=chunk_table(torch.searchsorted(com[corder], span), M),
                members=p.members[corder].to(i32), w=p.weights[corder],
                counts=p.counts[by_first], trec=chunk_table(toff, M),
                tcls=com[order].to(i32), tw=p.weights[order],
                empty=toff[1:] == toff[:-1])


def _iterate_cuda(p: _Problem, alpha, *, min_iter: int, max_iter: int,
                  rel_diff_tol: float):
    """`_iterate` with the EM step in one launch of csrc/em.cu
    (`sf_em_solve`) on the current stream of alpha's CUDA device; the
    kernel's tables are built there first, queued.  Returns what
    `_iterate` returns; the host waits once, on the kernel's result
    block."""
    from .. import _ext

    dev = alpha.device
    if dev.type != "cuda" or alpha.dtype not in (torch.float32,
                                                  torch.float64):
        raise ValueError("the EM kernel takes float32 or float64 alphas on "
                         f"a CUDA device, not {alpha.dtype} on {dev}")
    C, T, M = p.singleton.shape[0], p.num_txps, p.members.shape[0]
    if alpha.shape != (T,) or p.counts.shape != (C,) \
            or max(C, T) + M >= 2 ** 31:
        raise ValueError(f"the EM kernel takes one alpha vector of {T} and "
                         "one count a class, and int32 indices; got alpha "
                         f"{tuple(alpha.shape)}, counts "
                         f"{tuple(p.counts.shape)}, {M} members")
    arrays = (p.members, p.com, p.weights, p.counts, p.sing_out)
    if any(a.device != dev for a in arrays) \
            or any(a.dtype != alpha.dtype for a in arrays[2:]):
        raise ValueError("the EM problem and its alphas must share the "
                         "card and the value type")
    tb = kernel_tables(p)
    # no chunk reads or writes a transcript in no class: its alpha is 0
    # after the first iteration, in both buffers
    start = alpha.masked_fill(tb["empty"], 0.0)
    nxt = torch.zeros_like(alpha)
    scale = torch.empty(C, dtype=alpha.dtype, device=dev)
    crec, trec = tb["crec"], tb["trec"]
    part = torch.empty(max(len(crec), len(trec)), dtype=alpha.dtype,
                       device=dev)
    arrived = torch.zeros(max(C, T), dtype=torch.int32, device=dev)
    result = torch.zeros(4, dtype=torch.int32, device=dev)
    kl = _ext.load()
    err = kl.lib.sf_em_solve(
        int(alpha.dtype == torch.float64), EM_CHUNK, crec.data_ptr(),
        len(crec), tb["members"].data_ptr(), tb["w"].data_ptr(),
        tb["counts"].data_ptr(), trec.data_ptr(), len(trec),
        tb["tcls"].data_ptr(), tb["tw"].data_ptr(), p.sing_out.data_ptr(),
        start.data_ptr(), nxt.data_ptr(), scale.data_ptr(), part.data_ptr(),
        arrived.data_ptr(), result.data_ptr(), p.min_w, _ALPHA_CHECK_CUTOFF,
        float(rel_diff_tol), _clamp_i32(min_iter), _clamp_i32(max_iter),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    kl.check(err, "em_solve kernel launch")
    trace.count("launch.em_solve")
    it, converged = result[:2].tolist()
    # iteration i writes the other buffer: the latest alphas are in
    # `start` after an even count
    bufs = (alpha, None) if it == 0 else (start, nxt) if it % 2 == 0 \
        else (nxt, start)
    return bufs[1], bufs[0], it, bool(converged), 1


def _clamp_i32(n: int) -> int:
    return max(-(2 ** 31), min(int(n), 2 ** 31 - 1))


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
    with trace.span("em.solve", trace.new_id()):
        with trace.span("em.upload"):
            p = _Problem(eq, eff_lens, num_txps, dev, dtype)
            active = np.zeros(num_txps, dtype=bool)
            active[np.unique(eq.members)] = True
            num_active = int(active.sum())
            if num_active == 0:
                raise RuntimeError(
                    "no transcripts are expressed; mapping failed?")
            if alpha0 is None:
                alpha0 = np.where(active, total_mapped / num_active, 0.0)
            alpha = torch.as_tensor(np.asarray(alpha0), dtype=dtype,
                                    device=dev)
        limits = dict(min_iter=min_iter, max_iter=max_iter,
                      rel_diff_tol=rel_diff_tol)
        with trace.span("em.iterate"):
            if uses_kernel(dev, use_vbem):
                prev, alpha, it, converged, waits = _iterate_cuda(
                    p, alpha, **limits)
            else:
                prev, alpha, it, converged, waits = _iterate(
                    p, alpha, _vbem_step if use_vbem else _em_step,
                    **limits)
        syncs = p.uploads + 1 + waits
        with trace.span("em.pull"):
            max_rel = float("-inf")
            if prev is not None:
                check = alpha > _ALPHA_CHECK_CUTOFF
                syncs += 1
                if bool(check.any()):
                    rel = (prev - alpha).abs() / torch.where(check, alpha,
                                                             1.0)
                    # the mask's nonzero, then the value
                    max_rel = float(rel[check].max())
                    syncs += 2
            raw = alpha.cpu().numpy().astype(np.float64)
            syncs += 1
        trace.count("em.iterations", it)
        trace.count("em.syncs", syncs)
    alphas = raw.copy()
    alphas[alphas <= truncation_cutoff(use_vbem)] = 0.0
    return EMResult(alphas=alphas, num_iterations=it, max_rel_diff=max_rel,
                    converged=converged, alphas_raw=raw)
