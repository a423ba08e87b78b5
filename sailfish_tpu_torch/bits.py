"""Unsigned 32-bit arithmetic on int64 tensors.

The JAX package hashes in uint32.  Torch on the CPU has no `>>` on
uint32, so the port carries every 32-bit word as an int64 in [0, 2**32)
and masks after each operation.  Products are split into 16-bit halves
so no int64 intermediate ever overflows.  Results are bit-equal to the
JAX package's uint32 math."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and c an int or a tensor in
    [0, 2**32)."""
    lo = x & 0xFFFF
    hi = x >> 16
    return ((((hi * c) & M32) << 16) + lo * c) & M32


def mix_kmer(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """index/kmerhash.mix_hash_u32: the k-mer table's bucket hash."""
    h = mul32(k0, 0x9E3779B1) ^ mul32(k1, 0x85EBCA77)
    h = h ^ (h >> 15)
    h = mul32(h, 0xC2B2AE3D)
    return h ^ (h >> 13)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """map/pair._mix32: the murmur3 finalizer."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)
