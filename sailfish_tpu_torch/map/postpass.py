"""Scan post-pass: position-consistent intersection of a lane's MMPs,
dedupe per transcript (smallest position), sort by transcript.

Counterpart of sailfish_tpu/map/pallas_kernel.py `_intersect_sort` (and
the tail of map/kernels.py `map_oriented_lanes`).  Torch ops on either
device.  The JAX version tests every (base, later-MMP) candidate pair,
an (R, C, C) product; here each later MMP's valid (txp, pos) keys are
sorted per row and the base keys looked up with a batched searchsorted,
which keeps memory at O(R*C) for C up to the escalation capacity.
"""

from __future__ import annotations

import torch

NEG = 2**31 - 1        # sentinel transcript id of invalid slots
_KEY_MAX = 2**63 - 1   # sorts after every valid (txp, pos) key


def _key(txp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(txp, pos) -> one int64 ordering txp major, pos minor (pos may be
    negative: offset by 2**31)."""
    return (txp.to(torch.int64) << 32) | (pos.to(torch.int64) + 2**31)


def intersect_sort(gtxp, gpin, vld, nm, *, C: int, M: int):
    """(R, M*C) scan slots + (R,) MMP counts -> (txp, pos, valid), each
    (R, C): the first MMP's loci consistent with every later MMP, one per
    transcript (smallest position), sorted by transcript, valid first."""
    R = gtxp.shape[0]
    m_txp = gtxp.view(R, M, C)
    m_pos = gpin.view(R, M, C)
    m_vld = vld.view(R, M, C)
    htxp, hpos = m_txp[:, 0], m_pos[:, 0]
    hvalid = m_vld[:, 0].clone()
    base = _key(htxp, hpos)
    for m in range(1, M):
        rows = (nm > m).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        keys = torch.where(m_vld[rows, m], _key(m_txp[rows, m],
                                                m_pos[rows, m]), _KEY_MAX)
        keys = keys.sort(dim=1).values
        b = base[rows].contiguous()
        at = torch.searchsorted(keys, b).clamp(max=C - 1)
        hvalid[rows] &= keys.gather(1, at) == b
    key_t = torch.where(hvalid, htxp, NEG)
    order = _key(key_t, hpos).sort(dim=1, stable=True).indices
    s_txp = htxp.gather(1, order)
    s_pos = hpos.gather(1, order)
    s_vld = hvalid.gather(1, order)
    dup = (s_txp[:, 1:] == s_txp[:, :-1]) & s_vld[:, :-1]
    s_vld[:, 1:] &= ~dup
    return s_txp, s_pos, s_vld
