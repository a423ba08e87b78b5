"""The quasi-mapping index carried onto the device.

Counterpart of the JAX package's device index images
(sailfish_tpu/map/pipeline.py DeviceMapperBackend.text and
map/pallas_kernel.py prepare_pallas_text).  The port keeps one plain
layout for both the CUDA kernel and its torch reference: the true text
codes (separators and transcript Ns are code 4), the suffix array, and
the bucketed k-mer table with each 4-entry bucket fused into one
64-byte row [key0 x4 | key1 x4 | lo x4 | cnt x4], so a probe reads one
cache line.  The text is uploaded with TEXT_PAD trailing bytes of code 4
behind its final separator: the CUDA scan compares 16 text bytes at a
time from any candidate position, and the padding keeps the last such
read inside the allocation.  `n_text` stays the true length; the suffix
array and `txp_of_pos` cover the true text only.  The (8,128)-tile
images, fused text rows and the image caches of the TPU path are not
needed here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_device
from ..dna import SEP
from .builder import QuasiIndex

TEXT_PAD = 16


@dataclasses.dataclass
class TorchIndex:
    k: int
    n_text: int                   # text positions, without the padding
    ht_bits: int                  # the table has 2**ht_bits buckets
    ht_probes: int                # exact worst-case probe chain (buckets)
    codes: torch.Tensor           # uint8[N + TEXT_PAD] true text codes
                                  # (SEP = 4), then TEXT_PAD bytes of 4
    sa: torch.Tensor              # int32[N] suffix array (A-substituted order)
    ht: torch.Tensor              # int32[S, 16] fused k-mer table buckets
    txp_of_pos: torch.Tensor      # int32[N] text position -> transcript id
    txp_offsets: torch.Tensor     # int32[T] transcript start positions
    txp_lens: torch.Tensor        # int32[T]
    device: torch.device

    @classmethod
    def from_quasi_index(cls, index: QuasiIndex, device) -> "TorchIndex":
        """Upload a host QuasiIndex (index/builder.py) to `device`.  Only
        32-bit indexes with a k-mer table (k >= 17) are ported; anything
        else raises."""
        if index.big_sa:
            raise NotImplementedError(
                "64-bit (big_sa) indexes are not supported by the torch "
                "port yet")
        if index.kmer_ht is None:
            raise ValueError(
                "the torch port maps through the k-mer table; build the "
                "index with k >= 17")
        if len(index.codes) == 0 or index.codes[-1] != SEP:
            raise ValueError("the index text must end in a separator")
        dev = as_device(device)
        ht = index.kmer_ht
        fused = np.concatenate(
            [ht["ht_key0"].view(np.int32), ht["ht_key1"].view(np.int32),
             ht["ht_lo"].astype(np.int32), ht["ht_cnt"].astype(np.int32)],
            axis=1,
        )

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        return cls(
            k=int(index.k),
            n_text=len(index.codes),
            ht_bits=int(ht["ht_bits"]),
            ht_probes=int(ht["max_probes"]),
            codes=up(np.concatenate(
                [index.codes, np.full(TEXT_PAD, SEP, np.uint8)]), np.uint8),
            sa=up(index.sa, np.int32),
            ht=up(fused, np.int32),
            txp_of_pos=up(index.txp_of_pos, np.int32),
            txp_offsets=up(index.txp_offsets, np.int32),
            txp_lens=up(index.txp_lens, np.int32),
            device=dev,
        )
