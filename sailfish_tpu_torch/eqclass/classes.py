"""Equivalence-class containers.

The reference aggregates classes in a concurrent cuckoo hash keyed by the
(ordered) transcript-id label (include/EquivalenceClassBuilder.hpp:90-108).
Here the device path emits per-batch collapsed (label-hash, count,
representative-label) triples (see map/pipeline.py) and the host
accumulator merges them into a plain dict keyed by the exact label bytes —
hash collisions are therefore harmless.  The finished container is a CSR
layout ready for the jitted EM.

Labels are tuples of transcript ids in hit order (ascending, duplicates
possible for orphaned ends hitting the same transcript — see
refimpl/mapper.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


class EqClassAccumulator:
    """Host-side merge of per-batch (label -> count) contributions."""

    def __init__(self):
        self._counts: dict[tuple[int, ...], int] = {}

    def add(self, label: tuple[int, ...], count: int = 1) -> None:
        self._counts[label] = self._counts.get(label, 0) + count

    def add_many(self, labels, counts) -> None:
        d = self._counts
        for label, c in zip(labels, counts):
            t = tuple(label)
            d[t] = d.get(t, 0) + int(c)

    def merge(self, other: "EqClassAccumulator") -> None:
        for k, v in other._counts.items():
            self._counts[k] = self._counts.get(k, 0) + v

    def __len__(self) -> int:
        return len(self._counts)

    def finish(self) -> "EqClasses":
        # deterministic order: sort labels lexicographically so results
        # are independent of batch/host arrival order (the reference's
        # ordering is hash-table iteration order — arbitrary; ours is
        # canonical, which also makes the distributed merge reproducible).
        items = sorted(self._counts.items())
        return EqClasses.from_items(items)


class HashedEqClassAccumulator(EqClassAccumulator):
    """Host-side merge keyed by the 64-bit device label hash.

    The device fast path (DeviceMapperBackend.finish_batch_fast) sends
    per-batch (hash-key, count) pairs; the exact label bytes are fetched
    only the first time a key appears, so the per-batch label traffic
    decays to zero as the run saturates the class set.  `_counts` stays
    keyed by exact labels (so finish()/merge()/checkpoint dumps are
    identical to the base class); `_bykey` maps hash key -> label.

    Two distinct labels colliding on all 64 hash bits would merge their
    counts (~n^2/2^65 for n classes); the exact-label path
    (EqClassAccumulator + finish_batch) has no such risk and is what the
    differential tests run.
    """

    def __init__(self):
        super().__init__()
        self._bykey: dict[int, tuple[int, ...]] = {}

    def add_hashed(self, keys: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Fold counts for already-known hash keys; return the mask of
        keys seen for the first time (caller fetches their labels and
        calls register_new)."""
        new = np.zeros(len(keys), dtype=bool)
        bykey = self._bykey
        d = self._counts
        for i, (k, c) in enumerate(zip(keys.tolist(), counts.tolist())):
            label = bykey.get(k)
            if label is None:
                new[i] = True
            else:
                d[label] = d.get(label, 0) + c
        return new

    def register_new(self, keys, labels, counts) -> None:
        bykey = self._bykey
        d = self._counts
        for k, label, c in zip(keys.tolist(), labels, counts.tolist()):
            bykey[k] = label
            d[label] = d.get(label, 0) + c


@dataclasses.dataclass
class EqClasses:
    """CSR equivalence classes.

    members:  int32[M]  concatenated transcript ids, class-major
    offsets:  int64[C+1]
    counts:   int64[C]
    """

    members: np.ndarray
    offsets: np.ndarray
    counts: np.ndarray

    @staticmethod
    def from_items(items) -> "EqClasses":
        C = len(items)
        offsets = np.zeros(C + 1, dtype=np.int64)
        counts = np.zeros(C, dtype=np.int64)
        sizes = np.zeros(C, dtype=np.int64)
        for i, (label, c) in enumerate(items):
            sizes[i] = len(label)
            counts[i] = c
        np.cumsum(sizes, out=offsets[1:])
        members = np.zeros(int(offsets[-1]), dtype=np.int32)
        for i, (label, _) in enumerate(items):
            members[offsets[i] : offsets[i + 1]] = label
        return EqClasses(members=members, offsets=offsets, counts=counts)

    @property
    def num_classes(self) -> int:
        return len(self.counts)

    @property
    def num_members(self) -> int:
        return len(self.members)

    def labels(self):
        for i in range(self.num_classes):
            yield tuple(self.members[self.offsets[i] : self.offsets[i + 1]])

    def class_sizes(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int32)

    def class_of_member(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.num_classes, dtype=np.int32), self.class_sizes()
        )

    def total_count(self) -> int:
        return int(self.counts.sum())
