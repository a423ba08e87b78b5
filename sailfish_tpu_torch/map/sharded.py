"""Mapping backend over a sharded index.

Counterpart of sailfish_tpu/map/sharded.py `ShardedMapperBackend`: the
device backend of map/pipeline.py with its scan swapped for the sharded
one (parallel/shardidx.py) and each oriented hit block widened from C to
D x C columns (one C-wide slab per shard, shard-major, which keeps the
global transcript order).  Everything after the scan is the device
backend's.

Escalation (--hitCapacityMax) re-maps overflowed fragments through a
sibling backend at `effective_hit_capacity()` that shares this one's
shard tensors, as the JAX backend does (its --hitCapacityMax help says
sharded indexes disable escalation; its code escalates, and so does
this).  Bias correction is refused with the JAX message: it needs the
whole text on one device.

Placement: shard d goes to devices[d]; one device takes every shard
(the CLI passes `--device`).  The JAX backend puts shard d on device d
and refuses fewer devices than shards.
"""

from __future__ import annotations

import dataclasses

from ..config import QuantOpts
from ..device import as_device
from ..parallel.shardidx import TorchShards, map_oriented_lanes_sharded
from .pipeline import (DeviceMapperBackend, ShardedIndexRefusal,
                       StagingRing)


class ShardedMapperBackend(DeviceMapperBackend):
    def __init__(self, sidx, opts: QuantOpts, devices, *,
                 shards: TorchShards | None = None):
        if opts.bias_correct or opts.gc_bias_correct:
            raise ShardedIndexRefusal(
                "bias correction needs the whole transcriptome text on one "
                "device; it is not available with a sharded index")
        self.devices = [as_device(d) for d in devices]
        self.shards = (shards if shards is not None
                       else TorchShards.from_sharded(sidx, self.devices))
        self.device = self.shards.device
        self.opts = opts
        self._index = sidx
        self.tindex = None
        self.bias_text = None
        self._escb = None
        self._ring = StagingRing(self.device)

    @property
    def tail_cap(self) -> int:
        return len(self.shards.indexes) * self.opts.hit_capacity

    def _map(self, codes, lens, L, mates=1):
        # --scanShrink is ignored here, as the JAX package's sharded
        # backend ignores it
        o = self.opts
        return map_oriented_lanes_sharded(
            self.shards, codes, lens, cand_cap=o.hit_capacity,
            max_mmps=o.max_mmps, max_steps=o.effective_scan_steps(L),
            skip_jump=(o.mmp_skip == "jump"))

    def _esc_backend(self) -> "ShardedMapperBackend":
        """The wide pass over the same shards: a sibling at
        effective_hit_capacity() sharing the shard tensors."""
        if self._escb is None:
            opts2 = dataclasses.replace(
                self.opts, hit_capacity=self.opts.effective_hit_capacity(),
                hit_capacity_max=0, batch_size=self._ESC_ROWS)
            self._escb = ShardedMapperBackend(self._index, opts2,
                                              self.devices,
                                              shards=self.shards)
        return self._escb
