"""Oriented-lane mapping: lanes -> MMP scan -> post-pass.

Counterpart of sailfish_tpu/map/pallas_kernel.py
`map_oriented_lanes_pallas`, full-width path: every live lane goes to the
scan, at any read width L that is a multiple of 8 (the JAX package's
three routes by width — Pallas kernel, map/xlong.py, XLA kernel — give
the same hits by their contracts; the port has the one route).  The TPU
path's lane screen, clean-lane fast path, xscan and lane
compactions change no output by their own contracts and exist to keep
work off the TPU's scalar unit; they are not ported.
"""

from __future__ import annotations

import torch

from ..index.device import TorchIndex
from .encode import make_oriented_lanes
from .postpass import intersect_sort
from .scan import mmp_scan


def map_oriented_lanes(index: TorchIndex, codes: torch.Tensor,
                       lens: torch.Tensor, *, cand_cap: int, max_mmps: int,
                       max_steps: int, skip_jump: bool = False) -> dict:
    """(B, L) uint8 reads on the index's device -> per-lane hit dict over
    the 2B oriented lanes (fwd rows first, then rc): txp, pos, valid
    (2B, C) sorted by transcript; mlen, overflow, num_mapped_loci (2B,)."""
    lanes = make_oriented_lanes(codes, lens)
    txp, pos, vld, meta = mmp_scan(
        lanes, index, cand_cap=cand_cap, max_mmps=max_mmps,
        max_steps=max_steps, skip_jump=skip_jump)
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
