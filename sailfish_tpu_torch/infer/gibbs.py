"""Collapsed Gibbs sampler over equivalence classes.

Counterpart of sailfish_tpu/infer/gibbs.py.  Reference semantics
(src/CollapsedGibbsSampler.cpp): allocations are initialized by a
multinomial split of each class's count proportional to (priorAlpha +
EM-mass_t) * aux_t (:35-94); then each emitted sample runs 10 internal
rounds, each round re-drawing a Uniform(0.25, 0.75) fraction of every
class's allocation from a multinomial conditioned on the current global
per-transcript counts (:96-186); priorAlpha = 1e-8 (:215); emitted
samples are integer per-transcript count vectors.

The chain is the JAX package's chromatic systematic scan over a wave
schedule.  The class-conflict graph (classes that share a transcript) is
coloured greedily on the host (`color_classes`); classes are packed into
waves of at most _CC_CAP same-colour classes, sorted by size so that a
wave's binomial chain is as long as its own largest class, rounded up
to a power of two (`_build_schedule`).  A round sweeps the waves in
order and resamples one wave's classes in parallel, conditioned on the
current counts.  Within a wave no transcript is shared, so those
conditionals are independent, and any sequential order of independent
groups is a valid systematic-scan Gibbs update of the reference's
posterior (held against a sequential port, refimpl/gibbs.py, by its
first two moments in tests/test_torch_samplers.py).

Here the sweep is a Python loop of torch ops: per wave and round about a
dozen launches plus nine per chain position (`schedule_launches`), for
each chain, with `torch.binomial` from the chain's own generator.  The
per-wave index tensors are built once.  Counts are float64 on the
device, exact to 2**53 fragments, so every sample sums to the mapped
total at any size (the JAX package's float32 chain is exact to 2**24).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..device import as_device
from ..eqclass.classes import EqClasses
from .em import class_weights

_PRIOR = 1e-8
_CC_CAP = 4096  # max classes resampled in one wave


def color_classes(eq: EqClasses) -> np.ndarray:
    """Greedy coloring of the class-conflict graph: two classes
    conflict when they share a transcript (ambiguous classes containing
    one transcript form a clique, so num_colors >= the max number of
    ambiguous classes any transcript belongs to).  Singleton classes
    never resample and all take color 0.

    Vectorized: per-transcript taken-color sets are uint64 bitmask rows
    (grown in 64-color words as needed); a class's used set is one OR
    reduction over its members' rows and its color the lowest zero bit.
    ~1-2s at 200k classes vs minutes for the old dict-of-sets loop."""
    C = eq.num_classes
    colors = np.zeros(C, dtype=np.int32)
    if C == 0:
        return colors
    sizes = (eq.offsets[1:] - eq.offsets[:-1]).astype(np.int64)
    T = int(eq.members.max()) + 1 if eq.num_members else 1
    W = 1
    masks = np.zeros((T, W), dtype=np.uint64)
    offsets = eq.offsets
    members = eq.members
    for c in range(C):
        if sizes[c] <= 1:
            continue
        tids = members[offsets[c] : offsets[c + 1]]
        rows = masks[tids]
        used = np.bitwise_or.reduce(rows, axis=0) if len(rows) > 1 else rows[0]
        free = ~used
        nz = np.nonzero(free)[0]
        if len(nz) == 0:
            # all W*64 colors taken: grow the bitmask width
            masks = np.concatenate(
                [masks, np.zeros((T, W), dtype=np.uint64)], axis=1
            )
            w = W
            W *= 2
            bit = 0
        else:
            w = int(nz[0])
            word = int(free[w])
            bit = (word & -word).bit_length() - 1
        colors[c] = w * 64 + bit
        masks[tids, w] |= np.uint64(1) << np.uint64(bit)
    return colors


def _build_schedule(eq: EqClasses, colors: np.ndarray):
    """Pack resamplable classes (size > 1) into waves of <= _CC_CAP
    same-color classes, size-sorted so co-waved classes have similar
    sizes; group waves by power-of-two chain-length TIER.

    Returns a list of (cids, tier_len): cids int32[(Wt, CC)] padded with
    -1; tier_len is the static binomial-chain length for that tier."""
    sizes = (eq.offsets[1:] - eq.offsets[:-1]).astype(np.int64)
    resamp = np.nonzero(sizes > 1)[0]
    if len(resamp) == 0:
        return []
    order = np.lexsort((sizes[resamp], colors[resamp]))
    resamp = resamp[order]
    col_sorted = colors[resamp]
    # wave boundaries: color changes, or _CC_CAP classes
    waves = []
    start = 0
    for i in range(1, len(resamp) + 1):
        if (
            i == len(resamp)
            or col_sorted[i] != col_sorted[start]
            or i - start >= _CC_CAP
        ):
            w = resamp[start:i]
            tier = 1 << int(int(sizes[w].max()) - 1).bit_length()
            waves.append((w, max(tier, 2)))
            start = i
    cc = min(_CC_CAP, max(int(max(len(w) for w, _ in waves)), 1))
    by_tier: dict[int, list] = {}
    for w, tier in waves:
        by_tier.setdefault(tier, []).append(w)
    tiers = []
    for tier in sorted(by_tier):
        ws = by_tier[tier]
        mat = np.full((len(ws), cc), -1, dtype=np.int32)
        for r, w in enumerate(ws):
            mat[r, : len(w)] = w
        tiers.append((mat, int(tier)))
    return tiers


def _init_allocations(rng, eq: EqClasses, p: np.ndarray, num_chains: int):
    """Vectorized multinomial split of each class's count by p
    (binomial chain over member positions, all classes in parallel —
    the old per-class rng.multinomial loop was minutes-slow at 200k
    classes).  Singleton and degenerate (sum p <= 0) classes assign the
    whole count to their first member, matching the reference init."""
    C, M = eq.num_classes, eq.num_members
    off = eq.offsets[:-1].astype(np.int64)
    sizes = (eq.offsets[1:] - eq.offsets[:-1]).astype(np.int64)
    counts = eq.counts.astype(np.int64)
    max_size = int(sizes.max()) if C else 1
    # per-class total prob (reduceat is wrong for empty classes; sizes>0
    # always holds for real classes)
    rem_p0 = np.add.reduceat(p, eq.offsets[:-1]) if M else np.zeros(C)
    rem_p0 = np.where(sizes > 0, rem_p0, 0.0)
    degen = (rem_p0 <= 0) | (sizes == 1)
    # all chains ride one (num_chains, C) binomial per chain-step
    cm = np.zeros((num_chains, M), dtype=np.float64)
    rem_n = np.broadcast_to(np.where(degen, 0, counts), (num_chains, C)).copy()
    rem_p = rem_p0.copy()
    for j in range(max_size):
        act = (j < sizes) & ~degen
        midx = np.minimum(off + j, M - 1)
        p_j = np.where(act, p[midx], 0.0)
        last = j == sizes - 1
        safe = np.where(rem_p > 0, rem_p, 1.0)
        fr = np.clip(p_j / safe, 0.0, 1.0)
        x = rng.binomial(np.maximum(rem_n, 0), fr[None, :])
        x = np.where((act & ~last)[None, :], x, 0)
        x = np.where((last & act)[None, :], np.maximum(rem_n, 0), x)
        for ch in range(num_chains):
            np.add.at(cm[ch], midx, x[ch])
        rem_n = rem_n - x
        rem_p = rem_p - p_j
    # degenerate/singleton: whole count to the first member
    sel = degen & (sizes > 0)
    cm[:, off[sel]] += counts[sel][None, :]
    return list(cm)


class _Wave:
    """One wave's static index tensors on the device: per class (row)
    and chain position (column) the member slot, its transcript, its aux
    weight, and where the class's members end."""

    def __init__(self, eq: EqClasses, cids: np.ndarray, L: int, weights,
                 num_txps: int, device):
        off = eq.offsets[:-1].astype(np.int64)[cids]
        sz = eq.class_sizes().astype(np.int64)[cids]
        jj = np.arange(L, dtype=np.int64)
        mmask = jj[None, :] < sz[:, None]
        M = eq.num_members
        midx = np.where(mmask, off[:, None] + jj[None, :], M)
        tid_pad = np.concatenate([eq.members.astype(np.int64), [num_txps]])
        aux_pad = np.concatenate([weights, [0.0]])

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.L = L
        self.mmask = up(mmask)
        self.midx = up(midx)
        self.tid = up(tid_pad[midx])
        self.aux = up(aux_pad[midx])
        self.last = up(jj[None, :] == (sz - 1)[:, None])
        self.mid = up(mmask & (jj[None, :] < (sz - 1)[:, None]))


def _sweep_wave(gen: torch.Generator, txp_pad, count_pad, w: _Wave) -> None:
    """Resample one wave's classes in place (one chain)."""
    cm_w = count_pad[w.midx]
    frac = 0.25 + 0.5 * torch.rand(cm_w.shape[0], generator=gen,
                                   dtype=cm_w.dtype, device=cm_w.device)
    res_w = torch.where(w.mmask, torch.round(frac[:, None] * cm_w), 0.0)
    n_c = res_w.sum(dim=1)
    txp_pad.index_add_(0, w.tid.reshape(-1), -res_w.reshape(-1))
    probs = torch.where(w.mmask, (_PRIOR + txp_pad[w.tid]) * w.aux, 0.0)
    denom = probs.sum(dim=1)
    ok = denom > 1e-30
    rem_n = torch.where(ok, n_c, 0.0)
    rem_p = denom.clone()
    draws = torch.zeros_like(cm_w)
    # multinomial via a binomial chain along the member positions
    for j in range(w.L):
        p_j = probs[:, j]
        left = rem_n.clamp(min=0.0)
        fr = (p_j / torch.where(rem_p > 0, rem_p, 1.0)).clamp(0.0, 1.0)
        x = torch.binomial(left, fr, generator=gen)
        x = torch.where(w.last[:, j], left,
                        torch.where(w.mid[:, j], x, 0.0))
        draws[:, j] = x
        rem_n -= x
        rem_p -= p_j
    # degenerate classes put their resampled mass back unchanged
    draws = torch.where(ok[:, None], draws, res_w)
    count_pad[w.midx] = torch.where(w.mmask, cm_w - res_w + draws, cm_w)
    txp_pad.index_add_(0, w.tid.reshape(-1), draws.reshape(-1))


def schedule_launches(tiers) -> dict:
    """Size of a schedule: its waves, its tier lengths, and the device
    launches one round of one chain makes (14 per wave plus 9 per chain
    position, counted from `_sweep_wave`)."""
    waves = sum(len(mat) for mat, _ in tiers)
    steps = sum(len(mat) * L for mat, L in tiers)
    return {"waves": waves, "tiers": [L for _, L in tiers],
            "chain_steps": steps, "launches_per_round": 14 * waves + 9 * steps}


def run_gibbs(
    eq: EqClasses,
    eff_lens: np.ndarray,
    em_alphas: np.ndarray,
    num_txps: int,
    *,
    device,
    num_samples: int,
    total_mapped: float,
    seed: int = 0,
    inner_rounds: int = 10,
    num_chains: int = 4,
) -> Iterator[np.ndarray]:
    """Yield integer count-vector samples (int32) in reference format."""
    dev = as_device(device)
    weights = class_weights(eq, eff_lens)
    T = num_txps
    num_chains = max(1, min(num_chains, num_samples))

    # init allocation: multinomial split by (prior + mass) * aux
    alpha_sum = em_alphas.sum()
    mass = (em_alphas / alpha_sum * total_mapped) if alpha_sum > 0 else em_alphas
    rng = np.random.default_rng(seed)
    p = (_PRIOR + mass[eq.members]) * weights
    init_counts = _init_allocations(rng, eq, p, num_chains)

    def up(a):
        return torch.from_numpy(
            np.concatenate([a, [0.0]]).astype(np.float64)).to(dev)

    # slot T of txp_pad and slot M of count_pad are the padding's sink
    chains = [
        (torch.Generator(device=dev).manual_seed(seed * 1000003 + i),
         up(np.bincount(eq.members, weights=cm, minlength=T)), up(cm))
        for i, cm in enumerate(init_counts)]
    tiers = _build_schedule(eq, color_classes(eq))
    waves = [_Wave(eq, row[row >= 0], L, weights, T, dev)
             for mat, L in tiers for row in mat]

    produced = 0
    while produced < num_samples:
        for gen, txp_pad, count_pad in chains:
            for _ in range(inner_rounds):
                for w in waves:
                    _sweep_wave(gen, txp_pad, count_pad, w)
        for _, txp_pad, _ in chains:
            if produced >= num_samples:
                break
            yield np.round(txp_pad[:T].cpu().numpy()).astype(np.int32)
            produced += 1
