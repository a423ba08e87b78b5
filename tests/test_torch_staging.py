"""The staging ring the device backend sends a batch's reads through
(map/pipeline.py `StagingRing`): batches staged before any is mapped
reuse and grow the ring's two slots, keep their own codes, and map as
each batch does alone; the wait on a slot whose copy is still in flight
is timed and counted."""

import numpy as np
import pytest
import torch

from sailfish_tpu_torch import trace
from sailfish_tpu_torch.config import QuantOpts
from sailfish_tpu_torch.index.builder import build_index
from sailfish_tpu_torch.io.fastq import FastqBatch
from sailfish_tpu_torch.libformat import parse_library_format
from sailfish_tpu_torch.map.encode import pack_reads, unpack_reads
from sailfish_tpu_torch.map.pipeline import DeviceMapperBackend
from torch_port import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, 400).astype(np.uint8) for _ in range(12)]
    return build_index([f"t{i}" for i in range(12)], seqs, k=31), seqs


def _pair(seqs, n, w1, w2, seed):
    """`n` fragments of 200 b: mates of widths `w1` and `w2`, each read 8
    bases shorter than its width or less (padded with code 4), an N in
    every 7th first mate and every 5th second mate."""
    rng = np.random.default_rng(seed)
    m1 = np.full((n, w1), 4, np.uint8)
    m2 = np.full((n, w2), 4, np.uint8)
    l1 = rng.integers(w1 - 8, w1 + 1, n).astype(np.int32)
    l2 = rng.integers(w2 - 8, w2 + 1, n).astype(np.int32)
    for i in range(n):
        s = seqs[rng.integers(len(seqs))]
        p = int(rng.integers(0, len(s) - 200))
        m1[i, :l1[i]] = s[p:p + l1[i]]
        m2[i, :l2[i]] = 3 - s[p + 200 - l2[i]:p + 200][::-1]
    m1[::7, 3] = 4
    m2[::5, 10] = 4
    return FastqBatch(m1, l1), FastqBatch(m2, l2)


def _same(got, want):
    assert got.n == want.n
    assert dict(zip(got.labels, got.label_counts.tolist())) == dict(
        zip(want.labels, want.label_counts.tolist()))
    for f in ("mapped", "num_joint", "unique_paired", "frag_lens",
              "fmt_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    for f in ("num_fwd", "num_rc", "num_compat"):
        assert getattr(got, f) == getattr(want, f), f


def test_batches_staged_ahead_map_as_alone(fresh, world, monkeypatch):
    """Three batches staged in a row before any is mapped (mates of two
    widths, single-end reads, mates of one width): the third overwrites
    the first's slot in place; the codes each `_map` receives are the
    batch's codes bit for bit, N and padding as 4, as `unpack_reads`
    gave them; each batch's result is that of mapping it alone."""
    idx, seqs = world
    pe, se = parse_library_format("IU"), parse_library_format("U")
    a = _pair(seqs, 56, 48, 40, seed=1)
    s = _pair(seqs, 40, 44, 44, seed=2)[0]
    c = _pair(seqs, 48, 48, 48, seed=3)
    be = DeviceMapperBackend(idx, QuantOpts(), "cpu")
    seen = []
    real = be._map

    def spy(codes, lens, L, mates=1):
        seen.append(codes.numpy().copy())
        return real(codes, lens, L, mates)

    monkeypatch.setattr(be, "_map", spy)
    pfs = [be.prefetch_pe(*a), be.prefetch_se(s)]
    slot = be._ring._bufs[0]
    pfs.append(be.prefetch_pe(*c))
    assert be._ring._bufs[0] is slot
    toks = [be.map_prefetched(pf, e) for pf, e in zip(pfs, (pe, se, pe))]
    got = [be.finish_batch(t) for t in toks]

    want_codes = [a[0].codes, a[1].codes, s.codes,
                  np.concatenate([c[0].codes, c[1].codes])]
    assert len(seen) == len(want_codes)
    for g, w in zip(seen, want_codes):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
        pw, nm = pack_reads(w)
        old = unpack_reads(torch.from_numpy(pw.view(np.int32)),
                           torch.from_numpy(nm.view(np.int32)), w.shape[1])
        np.testing.assert_array_equal(g, old.numpy())
    assert (want_codes[0] == 4).any() and (want_codes[0] < 4).any()

    alone = DeviceMapperBackend(idx, QuantOpts(), "cpu")
    wants = [alone.map_pe_batch(*a, pe), alone.map_se_batch(s, se),
             alone.map_pe_batch(*c, pe)]
    assert all(w.mapped.any() for w in wants)
    for g, w in zip(got, wants):
        _same(g, w)
    counters = trace.aggregates()["counters"]
    assert counters["map.stage_waits"] == 0
    assert "sync.stage" not in trace.aggregates()["spans"]


class _InFlight:
    """An event whose copy has not finished when first asked."""

    def __init__(self):
        self.waits = 0

    def query(self):
        return False

    def synchronize(self):
        self.waits += 1


def test_a_slot_in_flight_is_waited_for(fresh, world):
    """A slot whose copy has not finished is waited for once, under
    `sync.stage` inside `map.pack`, and counted under
    `map.stage_waits`; a batch larger than the slot grows it; the batch
    maps as it does alone."""
    idx, seqs = world
    pe = parse_library_format("IU")
    be = DeviceMapperBackend(idx, QuantOpts(), "cpu")
    small, big = _pair(seqs, 8, 48, 48, seed=4), _pair(seqs, 32, 48, 48,
                                                      seed=5)
    be.prefetch_pe(*small)
    be.prefetch_pe(*small)
    size = be._ring._bufs[0].numel()
    ev = be._ring._events[0] = _InFlight()
    got = be.finish_batch(be.submit_pe(*big, pe))
    assert ev.waits == 1
    assert be._ring._bufs[0].numel() > size
    _same(got, DeviceMapperBackend(idx, QuantOpts(), "cpu").map_pe_batch(
        *big, pe))
    agg = trace.aggregates()
    assert agg["counters"]["map.stage_waits"] == 1
    assert agg["spans"]["sync.stage"]["count"] == 1
    pack = agg["spans"]["map.pack"]
    assert pack["seconds"] >= agg["spans"]["sync.stage"]["seconds"]
