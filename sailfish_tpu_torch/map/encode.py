"""Read encoding: 2-bit packing for the host-to-device hop and the
oriented lane arrays the scan consumes.

Counterparts: sailfish_tpu/map/pipeline.py `_pack_reads` /
`_unpack_reads`, sailfish_tpu/map/encode.py `make_oriented_lanes` and
the per-base-codes path of map/pallas_kernel.py `_build_lanes`.

For a batch of B reads the lanes are 2B oriented reads: lane b is read b
as given (fwd), lane B+b its reverse complement (rc), left-aligned and
padded with code 4.  Per lane:

  codes  uint8 (2B, L)  true codes, 4 = N or padding
  lens   int32 (2B,)
  pw     int32 (2B, L)  16 bases packed 2-bit from each position i, the
                        earliest base in the most significant bits, with
                        N / padding substituted as A (the bits of the JAX
                        package's uint32 `pw_a`) — the k-mer hash key
  nmask  bool  (2B, L)  codes >= 4 (N or padding)
"""

from __future__ import annotations

import numpy as np
import torch

from ..bits import to_i32

SEP = 4


def pack_reads(codes: np.ndarray):
    """(B, L) uint8 codes -> (pw, nm) uint32 arrays on the host: 2-bit base
    words (16 bases per word, base j of the row at bits 2*(j % 16)) and a
    bitmask of code-4 positions (bit j % 32).  N packs as base 0 and is
    restored from the mask by `unpack_reads`."""
    B, L = codes.shape
    lp = -(-L // 32) * 32
    b2 = np.zeros((B, lp), np.uint8)
    b2[:, :L] = codes & 3
    t = b2[:, 0::2] | (b2[:, 1::2] << 2)
    t = t[:, 0::2] | (t[:, 1::2] << 4)
    pw = np.ascontiguousarray(t).view(np.uint32)
    nb = np.zeros((B, lp), np.uint8)
    nb[:, :L] = codes >= 4
    nm = np.packbits(nb, axis=1, bitorder="little").view(np.uint32)
    return pw, nm


def unpack_reads(pw: torch.Tensor, nm: torch.Tensor, L: int) -> torch.Tensor:
    """Inverse of `pack_reads` on the device.  `pw`/`nm` are int32 tensors
    holding the uint32 bit patterns; returns (B, L) uint8 codes."""
    dev = pw.device
    j = torch.arange(L, device=dev)
    w = pw.to(torch.int64)[:, j // 16]
    base = (w >> (2 * (j % 16))) & 3
    nbit = (nm.to(torch.int64)[:, j // 32] >> (j % 32)) & 1
    return torch.where(nbit == 1, SEP, base).to(torch.uint8)


def pack_words(codes: torch.Tensor) -> torch.Tensor:
    """(R, L) uint8 codes -> (R, L) int32 words: 16 bases from each
    position, N / padding (and the window past L) as A."""
    R, L = codes.shape
    sub = torch.where(codes >= 4, 0, codes).to(torch.int64)
    cp = torch.cat([sub, sub.new_zeros((R, 16))], dim=1)
    acc = torch.zeros((R, L), dtype=torch.int64, device=codes.device)
    for j in range(16):
        acc = (acc << 2) | cp[:, j:j + L]
    return to_i32(acc)


def make_oriented_lanes(codes: torch.Tensor, lens: torch.Tensor) -> dict:
    """(B, L) uint8 reads + (B,) lengths -> oriented lane dict (see the
    module docstring)."""
    B, L = codes.shape
    lens = lens.to(torch.int32)
    j = torch.arange(L, device=codes.device)
    src = lens.to(torch.int64)[:, None] - 1 - j[None, :]
    rc = torch.gather(codes, 1, src.clamp(0, L - 1))
    rc = torch.where(rc < 4, 3 - rc, SEP).to(torch.uint8)
    rc = torch.where(src >= 0, rc, SEP).to(torch.uint8)
    oc = torch.cat([codes, rc], dim=0).contiguous()
    return {
        "codes": oc,
        "lens": torch.cat([lens, lens]).contiguous(),
        "pw": pack_words(oc),
        "nmask": oc >= 4,
    }
