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
    identical to the base class).

    The fold of known keys is array work, not a loop over pairs: the
    known keys sit sorted beside their slots (`_skeys`, `_sslot`; a
    slot is a registered label's place in `_labels`), a searchsorted
    finds a batch's keys and their counts are added per slot into
    `_pending`, which reaches the exact-label dict only when `_counts`
    is read.

    Two distinct labels colliding on all 64 hash bits would merge their
    counts (~n^2/2^65 for n classes); the exact-label path
    (EqClassAccumulator + finish_batch) has no such risk and is what the
    differential tests run.
    """

    def __init__(self):
        super().__init__()
        self._skeys = np.zeros(0, np.uint64)
        self._sslot = np.zeros(0, np.int64)
        self._labels: list[tuple[int, ...]] = []
        self._pending = np.zeros(0, np.int64)
        self._dirty = False

    @property
    def _counts(self) -> dict[tuple[int, ...], int]:
        if self._dirty:
            nz = np.flatnonzero(self._pending)
            d, labels = self._exact, self._labels
            for s, c in zip(nz.tolist(), self._pending[nz].tolist()):
                d[labels[s]] += c
            self._pending[nz] = 0
            self._dirty = False
        return self._exact

    @_counts.setter
    def _counts(self, d) -> None:
        self._exact = d

    def add_hashed(self, keys: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Fold counts for already-known hash keys; return the mask of
        keys seen for the first time (caller fetches their labels and
        calls register_new)."""
        keys = np.asarray(keys, np.uint64)
        if not len(self._skeys):
            return np.ones(len(keys), dtype=bool)
        # searchsorted is several times faster on ascending queries
        order = np.argsort(keys)
        pos = np.empty(len(keys), np.int64)
        pos[order] = np.searchsorted(self._skeys, keys[order])
        np.minimum(pos, len(self._skeys) - 1, out=pos)
        hit = self._skeys[pos] == keys
        if hit.any():
            np.add.at(self._pending, self._sslot[pos[hit]],
                      np.asarray(counts, np.int64)[hit])
            self._dirty = True
        return ~hit

    def register_new(self, keys, labels, counts) -> None:
        keys = np.asarray(keys, np.uint64)
        n0 = len(self._labels)
        self._labels.extend(labels)
        d = self._exact
        for label, c in zip(self._labels[n0:], np.asarray(counts).tolist()):
            d[label] = d.get(label, 0) + c
        order = np.argsort(keys, kind="stable")
        at = np.searchsorted(self._skeys, keys[order])
        self._skeys = np.insert(self._skeys, at, keys[order])
        self._sslot = np.insert(self._sslot, at, n0 + order)
        if len(self._labels) > len(self._pending):
            grown = np.zeros(max(2 * len(self._pending), len(self._labels),
                                 1024), np.int64)
            grown[:len(self._pending)] = self._pending
            self._pending = grown

    def keyed_counts(self):
        """(keys uint64, counts int64) of the classes registered by key,
        in the order they were registered."""
        keys = np.empty(len(self._sslot), np.uint64)
        keys[self._sslot] = self._skeys
        d = self._counts
        return keys, np.array([d[lab] for lab in self._labels], np.int64)


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
