"""Oriented-lane mapping: lanes -> MMP scan -> post-pass.

Counterpart of sailfish_tpu/map/pallas_kernel.py
`map_oriented_lanes_pallas`, full-width path: every live lane goes to the
scan, at any read width L that is a multiple of 8 (the JAX package's
three routes by width — Pallas kernel, map/xlong.py, XLA kernel — give
the same hits by their contracts; the port has the one route).  The TPU
path's lane screen, clean-lane fast path, xscan and lane
compactions change no output by their own contracts and exist to keep
work off the TPU's scalar unit; they are not ported.  The XLA kernel's
compacted scan (`scan_shrink > 1`) does change the output: the scan then
records its step stamps and map/shrink.py cuts its outputs as that kernel
would have.
"""

from __future__ import annotations

import torch

from ..index.device import TorchIndex
from .encode import make_oriented_lanes
from .postpass import intersect_sort
from .scan import mmp_scan
from .shrink import apply_cut, cut_steps


def map_oriented_lanes(index: TorchIndex, codes: torch.Tensor,
                       lens: torch.Tensor, *, cand_cap: int, max_mmps: int,
                       max_steps: int, skip_jump: bool = False,
                       scan_shrink: int = 1,
                       pad_lanes: int | None = None) -> dict:
    """(B, L) uint8 reads on the index's device -> per-lane hit dict over
    the 2B oriented lanes (fwd rows first, then rc): txp, pos, valid
    (2B, C) sorted by transcript; mlen, overflow, num_mapped_loci (2B,).
    `scan_shrink` > 1 compacts the scan as the XLA kernel does over
    `pad_lanes` lanes (default 2B): the lane count of the JAX package's
    call, whose batch is padded to --batchSize."""
    lanes = make_oriented_lanes(codes, lens)
    kw = dict(cand_cap=cand_cap, max_mmps=max_mmps, max_steps=max_steps,
              skip_jump=skip_jump)
    if scan_shrink > 1:
        txp, pos, vld, meta, stamps = mmp_scan(lanes, index, stamps=True,
                                               **kw)
        end = cut_steps(stamps, meta, shrink=scan_shrink,
                        width0=pad_lanes or meta.shape[0],
                        max_steps=max_steps)
        txp, pos, vld, meta = apply_cut(txp, pos, vld, meta, stamps, end,
                                        C=cand_cap, M=max_mmps)
    else:
        txp, pos, vld, meta = mmp_scan(lanes, index, **kw)
    s_txp, s_pos, s_vld = intersect_sort(txp, pos, vld, meta[:, 0],
                                         C=cand_cap, M=max_mmps)
    return {
        "txp": s_txp,
        "pos": s_pos,
        "valid": s_vld,
        "mlen": meta[:, 2],
        "overflow": meta[:, 1] != 0,
        "num_mapped_loci": s_vld.sum(dim=1),
    }
