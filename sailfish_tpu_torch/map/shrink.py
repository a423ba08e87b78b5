"""The compacted scan of `--scanShrink N`: which lanes the JAX package's
XLA kernel stops early, applied to the outputs of one uncompacted scan.

Counterpart of the `scan_shrink > 1` branch of sailfish_tpu/map/kernels.py
`map_oriented_lanes` (without `shrink_exact`, which only its xlong path
sets).  There, over B2 lanes and S steps, step 0 runs every lane; before
each step s = 1 .. S-1 the width shrinks to W_s = max(64, W_{s-1} // N),
W_0 = B2, and a stable argsort of the lanes by priority (0: active with an
MMP, 1: active without, 2: done) runs the first W_s.  Every other active
lane stops (its position set past the read): it keeps the MMPs, mlen and
overflow it has and is done from then on.  The code does that; the
module docstring there speaks of dropping such lanes as overflow, which
only `shrink_exact` does.

A lane that is not stopped runs as it would uncompacted, and the ranking
reads only each lane's priority, which the scan's step stamps and its
step count (map/scan.py) give at every step.  So the port scans once,
uncompacted, with stamps, and cuts here: `cut_steps` finds where each
lane stops, `apply_cut` drops what it found from then on.  Plain torch on
the outputs' device, as the JAX package runs it in plain jnp outside its
kernels.  B2 there counts the padding of a batch to --batchSize, whose
lanes are always done; the caller gives that count as `width0`.
"""

from __future__ import annotations

import torch


def cut_steps(stamps: torch.Tensor, meta: torch.Tensor, *, width0: int,
              shrink: int, max_steps: int) -> torch.Tensor:
    """(B2,) int64: the steps each lane runs under the compaction, at
    most its uncompacted count meta[:, 3].  A priority-0 lane's rank is
    its index among the priority-0 lanes, a priority-1 lane's the number
    of priority-0 lanes plus its index among the priority-1 lanes; a lane
    of rank W_s or more stops before step s.  The loop runs to the
    longest lane's uncompacted step count: no lane is active after it."""
    end = meta[:, 3].to(torch.int64)
    # the step of each lane's first MMP; past every step where it has none
    first = stamps[:, 0].to(torch.int64)
    first = torch.where(first >= 0, first, max_steps)
    last = min(max_steps, int(end.max()))
    width = width0
    for s in range(1, last):
        width = max(64, width // shrink)
        alive = end > s
        p0 = alive & (first < s)
        p1 = alive & ~p0
        c0 = p0.cumsum(0)
        rank = torch.where(p0, c0 - 1, c0[-1] + p1.cumsum(0) - 1)
        end = torch.where(alive & (rank >= width), s, end)
    return end


def apply_cut(txp, pos, vld, meta, stamps, end, *, C: int, M: int):
    """The scan's outputs as the compacted scan leaves them when lane j
    stops after end[j] steps: the MMPs recorded before then, the rest
    zero; `nm` their number; mlen kept only if MMP 0 is among them;
    overflow only if it fired before then; meta[:, 3] = end.  Returns
    (txp, pos, valid, meta), new tensors."""
    st = stamps[:, :M].to(torch.int64)
    kept = (st >= 0) & (st < end[:, None])
    nm = kept.sum(1)
    slot = kept.repeat_interleave(C, dim=1)
    txp = torch.where(slot, txp, 0)
    pos = torch.where(slot, pos, 0)
    vld = vld & slot
    ov = stamps[:, M].to(torch.int64)
    over = (ov >= 0) & (ov < end)
    mlen = torch.where(kept[:, 0], meta[:, 2], 0)
    meta = torch.stack([nm.to(meta.dtype), over.to(meta.dtype), mlen,
                        end.to(meta.dtype)], dim=1)
    return txp, pos, vld, meta
