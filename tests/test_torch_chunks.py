"""The plain versions' count of 16-byte text chunks (`work["chunks"]`),
to which the card holds the prefix scan's and the facts kernel's chunk
counters, against a brute-force count on the toy world: a Python scan,
lane by lane, that walks each compared candidate's chunks in order and
stops at the first chunk that holds a mismatch or the read's end.  Both
seed routes (the k = 31 index and a k = 15 index without a k-mer table),
C = 64 and C = 2, the toy reads (an N in every 7th) and the risk reads
(ragged lengths, reads that run to the text's end, Ns on k-mer edges)."""

import pytest
import torch

from sailfish_tpu.index.builder import build_index
from sailfish_tpu_torch.bits import u32
from sailfish_tpu_torch.index.device import TorchIndex
from sailfish_tpu_torch.map.encode import make_oriented_lanes
from sailfish_tpu_torch.map.facts import FactsMerge, facts_reference
from sailfish_tpu_torch.map.scan import (
    _probe,
    clean_counts,
    mmp_scan_reference,
    needed_chunks,
    prefix_seed,
)

from test_torch_scan import _reads
from torch_port import port_index, risk_reads
from torch_port import one_torch_thread  # noqa: F401  (autouse)

RISK_L = 104


@pytest.fixture(scope="module")
def indexes(toy_world):
    """Route -> the port's index of the toy world on the CPU."""
    k15 = build_index(toy_world["names"], toy_world["seqs"], k=15)
    return {route: TorchIndex.from_quasi_index(port_index(idx), "cpu")
            for route, idx in (("kmer", toy_world["idx"]), ("prefix", k15))}


def _lanes(toy_world, reads, k):
    if reads == "toy":
        codes, lens = _reads(toy_world, seed=5)
    else:
        codes, lens = risk_reads(toy_world["seqs"], k, RISK_L, seed=31)
    return make_oriented_lanes(torch.from_numpy(codes),
                               torch.from_numpy(lens))


def _seeds(tidx, lanes, C):
    """{(lane, p): (found, lo, cnt)} of every probed position (p + k <=
    len), from the port's seed of one index."""
    pw, lens = lanes["pw"], lanes["lens"].long()
    j = torch.arange(pw.shape[1])
    lane, p = (j[None, :] + tidx.k <= lens[:, None]).nonzero(as_tuple=True)
    if tidx.prefix_route:
        reads = torch.zeros(2, dtype=torch.int64)
        found, lo, cnt = prefix_seed(tidx, pw, clean_counts(lanes["codes"]),
                                     lens, lane, p, C, reads)
    else:
        found, lo, cnt, _ = _probe(
            tidx, u32(pw[lane, p]),
            u32(pw[lane, p + 16]) >> (2 * (32 - tidx.k)))
    return {(a, b): (f, lo_, c) for a, b, f, lo_, c in zip(
        lane.tolist(), p.tolist(), found.tolist(), lo.tolist(),
        cnt.tolist())}


def _walk(read, n, text, i, g):
    """(LCP, chunks read) of read[i:n] against text[g:], a 16-byte chunk
    at a time, up to the chunk that holds the first mismatch (an N in the
    read mismatches) or the read's end."""
    nch = (n - i + 15) // 16
    for ch in range(nch):
        for b in range(16):
            q = i + 16 * ch + b
            if q >= n:
                return n - i, ch + 1
            if read[q] > 3 or text[g + 16 * ch + b] != read[q]:
                return 16 * ch + b, ch + 1
    return n - i, nch


def _compared(tidx, lanes, lane, p, seed, C):
    """(largest LCP, chunks) over the candidates of a seed with
    0 < cnt <= C at (lane, p); None for any other seed."""
    found, lo, cnt = seed
    if not found or not 0 < cnt <= C:
        return None
    read = lanes["codes"][lane].tolist()
    n = int(lanes["lens"][lane])
    text, sa = tidx.codes.tolist(), tidx.sa.tolist()
    walks = [_walk(read, n, text, p, sa[lo + c]) for c in range(cnt)]
    return max(w[0] for w in walks), sum(w[1] for w in walks)


@pytest.mark.parametrize("cap", [64, 2])
@pytest.mark.parametrize("reads", ["toy", "risk"])
@pytest.mark.parametrize("route", ["kmer", "prefix"])
def test_scan_chunks_match_a_brute_force_count(toy_world, indexes, route,
                                               reads, cap):
    """The scan's plain version: `work["chunks"]` is the brute-force
    count over the positions that a sequential scan compares (its
    advance rule replayed here, under the nip rule), whose probed
    positions and MMP counts agree with the plain version's meta."""
    tidx = indexes[route]
    lanes = _lanes(toy_world, reads, tidx.k)
    k, M, L = tidx.k, 4, lanes["codes"].shape[1]
    work = {}
    meta = mmp_scan_reference(lanes, tidx, cand_cap=cap, max_mmps=M,
                              max_steps=L, work=work)[3]
    seeds = _seeds(tidx, lanes, cap)
    total = 0
    for lane in range(lanes["codes"].shape[0]):
        n = int(lanes["lens"][lane])
        i = nm = steps = 0
        while i + k <= n and nm < M and steps < L:
            steps += 1
            got = _compared(tidx, lanes, lane, i, seeds[lane, i], cap)
            if got is not None:
                total += got[1]
                if got[0] >= k:
                    nm += 1
                    i += max(1, got[0] - k + 1)
                    continue
            i += 1
        assert (nm, steps) == tuple(meta[lane, [0, 3]].tolist()), lane
    assert work["chunks"] == total > 0
    assert work["candidates"] <= work["chunks"]


@pytest.mark.parametrize("cap", [64, 2])
@pytest.mark.parametrize("reads", ["toy", "risk"])
@pytest.mark.parametrize("route", ["kmer", "prefix"])
def test_facts_chunks_match_a_brute_force_count(toy_world, indexes, route,
                                                reads, cap):
    """The facts mode's plain version on the index as one shard:
    `work["chunks"]` is the brute-force count over every probed position
    with 0 < cnt <= C (on the prefix route its second pass, at the levels
    of its own sizes, where the seed is the scan's), and its facts the
    brute-force largest LCPs."""
    tidx = indexes[route]
    lanes = _lanes(toy_world, reads, tidx.k)
    level = None
    if tidx.prefix_route:
        merge = FactsMerge(k=tidx.k, cand_cap=cap, prefix=True)
        merge.add(facts_reference(lanes, tidx, cand_cap=cap))
        level = merge.levels()
    work = {}
    facts = facts_reference(lanes, tidx, cand_cap=cap, level=level,
                            work=work)
    lstar = facts if tidx.prefix_route else facts[..., 1]
    total = 0
    for (lane, p), seed in _seeds(tidx, lanes, cap).items():
        got = _compared(tidx, lanes, lane, p, seed, cap)
        if got is not None:
            total += got[1]
        assert int(lstar[lane, p]) == (-1 if got is None else got[0])
    assert work["chunks"] == total > 0


def test_needed_chunks_counts_up_to_the_first_mismatching_chunk():
    """A mismatch at byte b costs b // 16 + 1 chunks; a match that
    reaches the read's end costs every chunk of the remainder."""
    lcp = torch.tensor([0, 15, 16, 31, 40, 40, 17, 16])
    rem = torch.tensor([50, 50, 50, 50, 40, 41, 17, 16])
    assert needed_chunks(lcp, rem).tolist() == [1, 1, 2, 2, 3, 3, 2, 1]
