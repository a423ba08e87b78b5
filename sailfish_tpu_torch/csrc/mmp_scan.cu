// MMP scan for NVIDIA Hopper (sm_90a): one warp per oriented read lane.
//
// Replaces sailfish_tpu/map/pallas_kernel.py::_scan_kernel (launched by
// mmp_scan_pallas).  It computes what that kernel computes, not how:
// the TPU kernel's (8,128)-tile DMAs with rolls, one-code-per-i32 text
// rows, lane-phase synchronisation and candidate banks exist to satisfy
// Mosaic's tiling rules and the TPU's single scalar unit, and have no
// counterpart here.
//
// The function, per lane (the sequential definition; map/scan.py
// mmp_scan_reference is its plain version):
//   while i + k <= len, nm < M, steps < max_steps:
//     probe the bucketed k-mer table with the A-substituted key of
//       read[i, i+k) (an N hashes as A), chasing up to ht_probes buckets;
//       an empty entry in a probed bucket is a miss
//     steps += 1; a miss advances i by 1
//     cnt > C: set overflow, advance 1 (no hit)
//     else each of the cnt candidates g = sa[lo + c] gets its LCP against
//       the true text codes from offset 0 (the table matched the
//       A-substituted key, not the codes; an N in the read, a separator
//       or N in the text and the read's end all stop a match, and a read
//       N never matches a text code 4); lstar is the largest, and on
//       lstar >= k the C slots of MMP nm get (transcript, in-transcript
//       position - i, lcp == lstar), candidate c in slot c;
//       advance i by lstar + 1 (jump) or max(1, lstar - k + 1) (nip)
//     a found k-mer without a hit advances 1
//
// What bounds it on the card: bytes.  The table rows (64 bytes each, at
// random addresses of a table far larger than the L2) and the M*C*9
// output bytes a lane are most of what must move; there is no matrix
// product in it.  A warp that waits for one dependent row at a time
// reaches a fraction of the memory rate, so the design keeps many loads
// in flight per warp and moves every byte once:
//   - the lane's rows (codes, packed words) are copied to shared memory
//     once, coalesced, and every key and every read byte comes from there;
//   - a probe window: thread t hashes the key of position i + t and
//     chases its own bucket chain, so up to 32 table rows are in flight
//     per warp.  The window is consumed in the sequential order: a
//     ballot finds the first position whose k-mer was found with
//     cnt <= C; the positions before it are misses or overflows, one
//     step each; a found k-mer without a hit and a nip advance that lands
//     inside the window go on consuming it, and it is refilled only when
//     i leaves it.  A window never reaches past len - k nor past the
//     remaining step budget, so a probe that is thrown away is no step.
//     A lane's first window is narrow (a read in its true orientation
//     maps on its first probe), every later one is full;
//   - the text compare runs on (candidate, 16-byte chunk) pairs spread
//     over the warp: read bytes from shared memory, text bytes by
//     aligned 32-bit loads funnel-shifted to the candidate's alignment,
//     byte equality and "read code <= 3" by SIMD byte intrinsics, the
//     first mismatch by __ffs, a candidate's LCP by atomicMin over its
//     chunks.  Word addresses are clamped to the text's allocation (which
//     carries 16 trailing bytes of code 4): bytes past the text's final
//     separator cannot lengthen a match;
//   - every output slot is written once, by the kernel: the found
//     candidates, zeros behind them, and zeros for the MMPs a lane did not
//     find, with 16-byte stores where alignment allows.  The caller hands
//     uninitialised buffers.
//
// Two instantiations of one kernel, by the type `Pos` of a suffix-array
// entry, a table `lo` and a transcript offset: int32 for the 32-bit index
// (sf_mmp_scan) and 64 bits for the 64-bit (big_sa) index of a text of
// 2^31 positions or more (sf_mmp_scan64; the TPU path routes that index
// to its XLA kernel, the Pallas kernel being int32 only).  The 64-bit
// table keeps the 64-byte rows, whose lo words hold the low 32 bits of
// lo; the high 32 bits lie in a side array `ht_hi` of one int32 per
// entry (index/device.py), read by a probe only for the entry that
// matched.  The 32-bit instantiation gets a null `ht_hi` and compiles the
// read away; the 64-bit one reads 4 bytes more per found k-mer and 8
// bytes per suffix-array entry and transcript offset.
//
// A second seed route, for an index without a k-mer table (k < 17; the
// XLA kernel's prefix-table seed, map/kernels.py `seed_prefix` with
// `_search_bound`; the Pallas kernel takes no such index): thread t of a
// window looks up position i + t's P-base prefix in `table_lo` and, while
// the interval holds more than C suffixes, narrows it by binary searches
// over the A-substituted 16-base words `packed[sa[m] + depth]` at depths 0
// and 16 (26 iterations at most, a suffix-array entry and a word each, at
// random addresses).  The advance rule and the slots are the k-mer
// route's; the compare is not.  The route is a template parameter
// (`kPrefix`), so the k-mer route's instantiations compile as before;
// `sf_mmp_scan_prefix` and `sf_mmp_scan_prefix64` launch the prefix route.
//
// What bounds the prefix route: bytes, as the k-mer route, but its
// candidates share only the P-base (or 16-base) seed with the read, so
// nearly every one mismatches inside its first 16 bytes, and a lane whose
// read maps nowhere compares at nearly every position.  Comparing every
// chunk of every candidate, one position after the other, read about 8
// times the text bytes needed through the caches and left most of the
// warp idle on a chain of dependent loads.  So the compare is a window-wide
// pass: when the scan reaches a part of kPart positions of a window, the
// (position, candidate) pairs of all its positions with 0 < cnt <= C are
// flattened over the warp (a prefix sum of the counts) and each thread
// compares its pairs' first 16-byte chunk, raising its position's largest
// LCP in shared memory (`window_compare`).  That settles a position when
// no candidate matched its first chunk whole (or the read ends inside it)
// and the largest LCP is below k: no hit, which the consume loop passes
// over as it passes a miss (one step, advance 1), so a lane whose read
// maps nowhere crosses a part in one ballot.  Any other position is a hit
// (k <= 16) or may be one, and is finished when the consume loop reaches
// it: each candidate walked chunk by chunk to its first mismatching chunk
// (`warp_walk_lstar`), its LCP kept for the slots.  A position's largest
// LCP does not depend on the scan's state, so comparing chunk 0 of
// positions that an advance then skips changes nothing but the chunks
// read; a part of 16 positions skips most of them (on an H100, 8 and 16
// time the same and 32 is 5 % slower on a batch of 65,536 paired 100 bp
// fragments at k = 15).  The text bytes a random 16-byte read moves (a
// 32-byte sector or two) rather than those compared then hold the route
// back, beside the seed's own latency (PERF.md).
//
// Step stamps (an optional output, for the XLA kernel's compacted scan,
// `--scanShrink`, map/shrink.py): per lane the step at which each MMP was
// recorded and the step of the first overflow.  A lane is active at step s
// exactly when s < meta[:, 3], and lanes are independent but for the XLA
// kernel's ranking between steps, so stamps and meta give every lane's
// rank at every step and a cut applied after one uncompacted launch is
// exact.  A window consumes several positions in one ballot: its first
// overflow's step is the step count before the window plus the offset of
// the overflow's position, not the step at which the window ended.  With a
// null `stamps` nothing of this runs.
//
// A sharded index (a sub-index per contiguous transcript range, map/
// facts.py) needs the scan of the whole text, which no shard holds.  The
// scan's state enters a step only through `active` and `nm`, so what a
// shard knows of a (lane, position) does not depend on it: whether the
// seed was found, the interval's size, and the largest LCP over its
// min(size, C) candidates.  Three more modes take the scan apart:
//   - facts (`facts_kernel`, sf_mmp_facts): those of every position of
//     every lane, on one shard.  The prefix route's refinement trigger
//     and its proof of a miss use the sizes over all shards, so there it
//     runs twice: first the interval sizes at each refinement level, then,
//     for the level the merged sizes chose, the largest LCP;
//   - replay (`replay_kernel`): the sequential advance rule of each lane,
//     one thread a lane: step budget, overflow, the MMP count, the first
//     MMP's length and each MMP's position and length.  On the k-mer route
//     it reads every shard's facts and merges them at the positions it
//     visits (shards mode, sf_mmp_replay_shards); on the prefix route it
//     reads the merged facts (plane mode, sf_mmp_replay), because there
//     the second facts pass needs each position's refinement level, chosen
//     from the sizes summed over all shards at every position, before the
//     replay can run: that merge stays a torch pass over whole planes;
//   - slots (`slots_kernel`, sf_mmp_slots): on one shard, the seed and
//     the compare again at the replayed MMPs only, written as the scan
//     writes its slots, with the transcript ids moved by the shard's base
//     and a candidate valid when its LCP is the merged length.
// They give the scan's hits on the whole text: a facts pass probes every
// position, where the scan skips those behind a hit.
//
// What bounds the facts kernel: bytes (the table rows of every position
// and the facts written).  Every found position's largest LCP is wanted,
// and on the shard that holds a read's transcripts nearly every position
// finds a k-mer with a few candidates that match to the read's end.
// Comparing those one position at a time, a whole-warp compare each with
// a handful of threads busy, made a chain of some 70 dependent compares a
// lane.  So the facts kernel runs the window-wide pass of the prefix scan
// over each window of 32 positions, walking every pair to its first
// mismatching chunk: the chain becomes a few passes a lane, and no chunk
// is read that the LCPs do not need.
//
// What bounds the replay: bytes, the facts at the positions the advance
// visits.  A lane's walk is a chain of dependent loads (the next position
// depends on this one's fact), and its row lies at a stride of 4 L or
// 8 L bytes from its neighbours', so a warp's load touches 32 sectors.
// So a thread takes a whole 32-byte sector of its row at a time (two
// 16-byte loads; in shards mode those of all shards at once, independent
// of each other), consumes the sector's misses in one step, and merges
// the shards in registers: merging whole planes in torch first moved
// every position of every lane several times in int64, where the advance
// visits about 40 % of them.  Staging whole rows would read every sector
// of every shard.  What holds the shards mode now is the rate of these
// scattered sector reads: asking the L2 for more of each row (prefetching
// the next sectors, or whole 128-byte lines) made it slower (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
// threads that share a lane: 32 (one lane a warp) or 16 (two lanes a
// warp, each with a 16-wide window; 3 % slower on an H100 on a batch of
// 65,536 paired 100 bp fragments, where few threads idle for long)
constexpr int kGroup = 32;
constexpr int kLanesPerBlock = kWarpsPerBlock * (32 / kGroup);
// positions probed by a lane's first window: a read in its true
// orientation maps on its first probe, and rows probed beside it are
// thrown away (on an H100, 1, 2, 4 and 8 time the same and 32 is 10 %
// slower, reading a third more rows)
constexpr int kFirstWindow = 1;
// bytes of code 4 behind the read row in shared memory: a 16-byte compare
// that starts at the read's last base reads 19 bytes past it
constexpr int kReadPad = 32;

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// window positions a window pass of the prefix scan compares at once
constexpr int kPart = 16;

// the XLA kernel's binary-search iterations (map/kernels.py `bs_iters`)
constexpr int kSearchIters = 26;
// a facts entry for a refinement the lane cannot make at that position
constexpr int kNoRefine = INT_MIN;
// a merged fact: the position's interval overflows C
constexpr int kOverflow = -2;

// Shared memory of one lane: packed words, codes (padded), candidate LCPs.
__host__ __device__ constexpr int lane_smem_bytes(int L, int C) {
  return 4 * L + round16(L + kReadPad) + round16(4 * C);
}

// Per lane, the window-wide compare's: per window position its interval
// start, the start of its pairs and its largest LCP (struct Window).
constexpr int kWinBytes = kGroup * (8 + 4 + 4);

// The prefix scan's: the k-mer scan's, then the window-wide compare's.
__host__ __device__ constexpr int prefix_smem_bytes(int L, int C) {
  return lane_smem_bytes(L, C) + kWinBytes;
}

// The facts kernel's: rows and the window-wide compare's, no candidate
// LCPs.
__host__ __device__ constexpr int facts_smem_bytes(int L) {
  return 4 * L + round16(L + kReadPad) + kWinBytes;
}

__device__ __forceinline__ uint32_t mix_kmer(uint32_t k0, uint32_t k1) {
  // index/kmerhash.py mix_hash_u32
  uint32_t h = (k0 * 0x9E3779B1u) ^ (k1 * 0x85EBCA77u);
  h ^= h >> 15;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h;
}

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
}

// Zero `nbytes` at `p` with the threads of a group (`t` of kGroup):
// bytes up to the first 16-byte boundary, 16-byte stores, then the rest.
__device__ __forceinline__ void group_zero(uint8_t* p, size_t nbytes, int t) {
  const size_t head = min(nbytes, (size_t)((16 - ((uintptr_t)p & 15)) & 15));
  if ((size_t)t < head) p[t] = 0;
  p += head;
  nbytes -= head;
  const size_t nv = nbytes >> 4;
  uint4* p4 = reinterpret_cast<uint4*>(p);
  for (size_t v = t; v < nv; v += kGroup) p4[v] = make_uint4(0, 0, 0, 0);
  if ((size_t)t < (nbytes & 15)) p[(nv << 4) + t] = 0;
}

// One thread's table probe: chase the bucket chain of (key0, key1) from
// its home bucket.  Returns the number of 64-byte rows read.  A 64-bit
// `lo` takes its high word from `ht_hi` (4 per row), once, for the
// matching entry.
template <typename Pos>
__device__ __forceinline__ int probe(const int4* __restrict__ ht,
                                     const int32_t* __restrict__ ht_hi,
                                     uint32_t key0, uint32_t key1,
                                     uint32_t hmask, int ht_probes,
                                     bool& found, Pos& lo, int& cnt) {
  uint32_t h = mix_kmer(key0, key1) & hmask;
  int rows = 0;
  int match = 0;
  found = false;
  lo = 0;
  cnt = 0;
  for (int p = 0; p < ht_probes; ++p) {
    const int4* b = ht + (size_t)h * 4;
    const int4 k0v = __ldg(b), k1v = __ldg(b + 1);
    const int4 lov = __ldg(b + 2), cv = __ldg(b + 3);
    ++rows;
    const int ek0[4] = {k0v.x, k0v.y, k0v.z, k0v.w};
    const int ek1[4] = {k1v.x, k1v.y, k1v.z, k1v.w};
    const int elo[4] = {lov.x, lov.y, lov.z, lov.w};
    const int ecn[4] = {cv.x, cv.y, cv.z, cv.w};
    bool empty = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!found && ecn[e] > 0 && ek0[e] == (int)key0 &&
          ek1[e] == (int)key1) {
        found = true;
        lo = elo[e];
        cnt = ecn[e];
        match = e;
      }
      empty |= (ecn[e] == 0);
    }
    if (found || empty) break;
    h = (h + 1) & hmask;
  }
  if constexpr (sizeof(Pos) == 8) {
    if (found) {
      lo = (Pos)(((unsigned long long)(uint32_t)__ldg(ht_hi + (size_t)h * 4
                                                      + match)
                  << 32) | (uint32_t)lo);
    }
  }
  return rows;
}

// First mismatching byte (0..16; 16 = none) of read bytes [qoff, qoff+16)
// of the lane's shared-memory row against text bytes [toff, toff+16).  A
// read code above 3 mismatches whatever the text holds.  Both sides are
// read as aligned words and funnel-shifted; a text word past `last_word`
// is replaced by that word (see the note on the padded text above).
__device__ __forceinline__ int first_mismatch16(
    const uint32_t* q_s, int qoff, const uint32_t* __restrict__ text_w,
    size_t toff, size_t last_word) {
  const int qa = qoff >> 2;
  const unsigned qsh = (unsigned)(qoff & 3) * 8u;
  const size_t ta = toff >> 2;
  const unsigned tsh = (unsigned)(toff & 3) * 8u;
  uint32_t qw[5], tw[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    qw[j] = q_s[qa + j];
    tw[j] = __ldg(text_w + min(ta + j, last_word));
  }
  int n = 16;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    const uint32_t a = __funnelshift_r(qw[j], qw[j + 1], qsh);
    const uint32_t b = __funnelshift_r(tw[j], tw[j + 1], tsh);
    const uint32_t bad = ~(__vcmpeq4(a, b) & __vcmpgtu4(0x04040404u, a));
    if (bad) n = 4 * j + ((__ffs((int)bad) - 1) >> 3);
  }
  return n;
}

// No code above 3 in bytes [off, off + n), n <= 16, of the lane's
// shared-memory row (word-aligned, padded behind the read): four words
// funnel-shifted to the offset, a byte with a bit above the lowest two
// being bad.
__device__ __forceinline__ bool acgt(const uint8_t* q8, int off, int n) {
  const uint32_t* q_s = reinterpret_cast<const uint32_t*>(q8);
  const int qa = off >> 2;
  const unsigned qsh = (unsigned)(off & 3) * 8u;
  uint32_t bad = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int keep = min(max(n - 4 * j, 0), 4);  // bytes of word j in range
    const uint32_t a = __funnelshift_r(q_s[qa + j], q_s[qa + j + 1], qsh);
    bad |= a & 0xFCFCFCFCu & low_bits(8 * keep);
  }
  return bad == 0;
}

__device__ __forceinline__ int clamp_int(long long n) {
  return n > INT_MAX ? INT_MAX : (int)n;
}

// First m in [lo, hi) whose key packed[sa[m] + depth] is >= val (> val
// when `upper`), by the XLA kernel's search: at most kSearchIters halvings
// (map/kernels.py `_search_bound`).  Adds the halvings to `reads`.
template <typename Pos>
__device__ __forceinline__ Pos search_bound(const Pos* __restrict__ sa,
                                            const uint32_t* __restrict__ packed,
                                            uint32_t val, Pos lo, Pos hi,
                                            int depth, bool upper,
                                            int& reads) {
  for (int it = 0; it < kSearchIters && lo < hi; ++it) {
    const Pos mid = lo + ((hi - lo) >> 1);
    const uint32_t key = __ldg(packed + (size_t)__ldg(sa + mid) + depth);
    ++reads;
    if (upper ? key <= val : key < val)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// [lo, hi) narrowed to the suffixes whose word at `depth` is `qa`:
// returns nhi - nlo (the XLA kernel's emptiness test, which may be
// negative where the interval is not ordered by that word) and sets
// [lo, hi) to [min(nlo, nhi), nhi).
template <typename Pos>
__device__ __forceinline__ long long refine(const Pos* __restrict__ sa,
                                            const uint32_t* __restrict__ packed,
                                            uint32_t qa, int depth, Pos& lo,
                                            Pos& hi, int& reads) {
  const Pos nlo = search_bound<Pos>(sa, packed, qa, lo, hi, depth, false,
                                    reads);
  const Pos nhi = search_bound<Pos>(sa, packed, qa, lo, hi, depth, true,
                                    reads);
  lo = nlo < nhi ? nlo : nhi;
  hi = nhi;
  return (long long)nhi - (long long)nlo;
}

// The prefix table's interval of the P-base prefix that opens `word`.
template <typename Pos>
__device__ __forceinline__ void coarse(const Pos* __restrict__ table_lo,
                                       uint32_t word, int pbits, Pos& lo,
                                       Pos& hi) {
  const uint32_t v = word >> (2 * (16 - pbits));
  lo = __ldg(table_lo + v);
  hi = __ldg(table_lo + v + 1);
}

// The prefix route's seed at position p of a lane (map/kernels.py
// `seed_prefix` on a whole index): no N in the first P bases, the coarse
// interval, then a refinement at depth 0 and at depth 16 while it holds
// more than C suffixes and the lane has 16 clean bases there.  An empty
// refinement proves a miss when its depth covers k bases; otherwise the
// interval before it stands.  A non-empty one replaces it.  `found` is a
// seed with at least one candidate.  Returns the table entries and search
// steps read (one for the coarse lookup).
template <typename Pos>
__device__ __forceinline__ int prefix_seed(
    const uint8_t* q8, const uint32_t* pw_s, int p, int len, int k, int C,
    const Pos* __restrict__ sa, const Pos* __restrict__ table_lo,
    const uint32_t* __restrict__ packed, int pbits, bool& found, Pos& lo,
    int& cnt) {
  found = false;
  lo = 0;
  cnt = 0;
  if (!acgt(q8, p, pbits)) return 0;
  Pos hi;
  coarse<Pos>(table_lo, pw_s[p], pbits, lo, hi);
  int reads = 1;
  for (int w = 0; w < 2; ++w) {
    const int depth = 16 * w;
    if (hi - lo > C && p + depth + 16 <= len && acgt(q8, p + depth, 16)) {
      Pos nlo = lo, nhi = hi;
      if (refine<Pos>(sa, packed, pw_s[p + depth], depth, nlo, nhi,
                      reads) <= 0) {
        if (k >= 16 * (w + 1)) return reads;  // a proven miss
      } else {
        lo = nlo;
        hi = nhi;
      }
    }
  }
  cnt = clamp_int((long long)(hi - lo));
  found = cnt > 0;
  return reads;
}

// Copies a lane's rows to its shared memory once, coalesced (L is a
// multiple of 8, so a pw row is a whole number of 16-byte vectors and a
// codes row of 8-byte ones, the codes padded with code 4); returns the
// lane's length.
__device__ __forceinline__ int load_lane(const uint8_t* __restrict__ codes,
                                         const int32_t* __restrict__ pw,
                                         const int32_t* __restrict__ lens,
                                         int lane, int L, int t,
                                         uint32_t* pw_s, uint32_t* q_s,
                                         unsigned gmask) {
  const uint4* src = reinterpret_cast<const uint4*>(pw + (size_t)lane * L);
  uint4* dst = reinterpret_cast<uint4*>(pw_s);
  for (int v = t; v < L / 4; v += kGroup) dst[v] = __ldg(src + v);
  const uint2* csrc = reinterpret_cast<const uint2*>(codes + (size_t)lane * L);
  uint2* cdst = reinterpret_cast<uint2*>(q_s);
  for (int v = t; v < round16(L + kReadPad) / 8; v += kGroup)
    cdst[v] = v < L / 8 ? __ldg(csrc + v)
                        : make_uint2(0x04040404u, 0x04040404u);
  __syncwarp(gmask);
  return min(lens[lane], L);
}

// The largest LCP of read bytes [i, len) of the lane's row against the
// cnt candidates sa[lo, lo + cnt), each LCP left in lcp_s[c]: the scan's
// compare, shared by the scan and the sharded modes.
template <typename Pos>
__device__ __forceinline__ int warp_lstar(const uint32_t* q_s, int* lcp_s,
                                          const uint32_t* __restrict__ text_w,
                                          size_t last_word,
                                          const Pos* __restrict__ sa, int i,
                                          int len, Pos lo, int cnt, int t,
                                          unsigned gmask) {
  const int rem = len - i;
  const int nch = (rem + 15) >> 4;
  for (int c = t; c < cnt; c += kGroup) lcp_s[c] = rem;
  __syncwarp(gmask);
  for (int pr = t; pr < cnt * nch; pr += kGroup) {
    const int c = pr / nch;
    const int ch = pr - c * nch;
    const Pos g = __ldg(sa + lo + c);
    const int n = first_mismatch16(q_s, i + 16 * ch, text_w,
                                   (size_t)g + 16 * ch, last_word);
    // a chunk without a mismatch bounds nothing (the next chunk, or the
    // read's end, does)
    if (n < 16) atomicMin(&lcp_s[c], 16 * ch + n);
  }
  __syncwarp(gmask);
  int best = -1;
  for (int c = t; c < cnt; c += kGroup) best = max(best, lcp_s[c]);
  return __reduce_max_sync(gmask, best);
}

// The walking compare of the prefix scan and the facts kernel.  The text
// is read as aligned 16-byte vectors (the allocation is 16-byte aligned);
// a vector index past `last_vec`, the last whole vector, is replaced by
// it.  That vector holds the first padding byte (code 4), which no read
// byte matches, and a walk goes on past a chunk only when the chunk
// matched whole, so a replaced vector never decides a match.

// The 16 text bytes from byte `sh` (0..15) of the vector pair (v0, v1)
// as four words.
__device__ __forceinline__ void text_words(const uint4& v0, const uint4& v1,
                                           unsigned sh, uint32_t (&tw)[4]) {
  const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  const unsigned sw = sh >> 2, bs = (sh & 3u) * 8u;
  uint32_t u[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    u[j] = sw == 0 ? w[j] : sw == 1 ? w[j + 1] : sw == 2 ? w[j + 2]
                                                          : w[j + 3];
#pragma unroll
  for (int j = 0; j < 4; ++j) tw[j] = __funnelshift_r(u[j], u[j + 1], bs);
}

// First mismatching byte (0..16; 16 = none) of read bytes [qoff, qoff+16)
// of the lane's shared-memory row against the text words `tw`; a read
// code above 3 mismatches whatever the text holds.  A byte is bad when it
// differs from the text's or has a bit above the lowest two: two logic
// operations a word, where the SIMD byte compares take several each.
__device__ __forceinline__ int mismatch16(const uint32_t* q_s, int qoff,
                                          const uint32_t (&tw)[4]) {
  const int qa = qoff >> 2;
  const unsigned qsh = (unsigned)(qoff & 3) * 8u;
  uint32_t qw[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) qw[j] = q_s[qa + j];
  int n = 16;
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    const uint32_t a = __funnelshift_r(qw[j], qw[j + 1], qsh);
    const uint32_t bad = (a ^ tw[j]) | (a & 0xFCFCFCFCu);
    if (bad) n = 4 * j + ((__ffs((int)bad) - 1) >> 3);
  }
  return n;
}

// The LCP of read bytes [i, i + rem) against the text from g, walking
// 16-byte chunks in order and stopping at the first chunk that mismatches,
// at most `max_chunks` of them; the next chunk's vector is in flight while
// one is compared.  After a walk cut short by `max_chunks` with no
// mismatch the result is 16 * max_chunks, a lower bound.  Adds the chunks
// compared to `chunks`.
template <typename Pos>
__device__ __forceinline__ int walk_lcp(const uint32_t* q_s, int i, int rem,
                                        const uint4* __restrict__ text_v,
                                        size_t last_vec, Pos g,
                                        int max_chunks, int& chunks) {
  const int nch = min((rem + 15) >> 4, max_chunks);
  const size_t a = (size_t)g >> 4;
  const unsigned sh = (unsigned)g & 15u;
  uint4 v0 = __ldg(text_v + min(a, last_vec));
  uint4 v1 = __ldg(text_v + min(a + 1, last_vec));
  for (int ch = 0; ch < nch; ++ch) {
    const uint4 v2 = ch + 1 < nch ? __ldg(text_v + min(a + ch + 2, last_vec))
                                  : v1;
    uint32_t tw[4];
    text_words(v0, v1, sh, tw);
    ++chunks;
    const int n = mismatch16(q_s, i + 16 * ch, tw);
    if (n < 16) return min(16 * ch + n, rem);
    v0 = v1;
    v1 = v2;
  }
  return min(16 * nch, rem);
}

// A lane's shared arrays of the window-wide compare, kWinBytes from `p`.
struct Window {
  unsigned char* lo;  // kGroup Pos entries: each position's interval start
  int* start;         // each position's first pair
  int* best;          // each position's largest LCP
  __device__ Window(uint8_t* p)
      : lo(p), start(reinterpret_cast<int*>(p + 8 * kGroup)),
        best(reinterpret_cast<int*>(p + 12 * kGroup)) {}
};

// The LCP of read bytes [i, i + rem) against the 16 text bytes from byte
// `sh` of (v0, v1), capped at 16: walk_lcp with max_chunks 1 on vectors
// already loaded.
__device__ __forceinline__ int first_chunk_lcp(const uint32_t* q_s, int i,
                                               int rem, const uint4& v0,
                                               const uint4& v1, unsigned sh) {
  uint32_t tw[4];
  text_words(v0, v1, sh, tw);
  return min(mismatch16(q_s, i, tw), rem);
}

// The window-wide compare.  Positions wb + t with `take` (0 < cnt <= C)
// put their (position, candidate) pairs in one list, ordered by a prefix
// sum of the counts over the group; thread t takes pairs t, t + kGroup, ...
// and raises its position's w.best[j] by atomicMax; w.best[j] is -1 for a
// position without pairs.  kFirstChunk: chunk 0 of each pair only (a
// result of 16 with more than 16 bases left is a lower bound), in a
// two-deep pipeline: a pair's text and the next pair's suffix-array entry
// are in flight while a pair is compared.  Otherwise each pair is walked
// to its first mismatching chunk, the next pair's suffix-array entry in
// flight during the walk.
template <typename Pos, bool kFirstChunk>
__device__ __forceinline__ void window_compare(
    const uint32_t* q_s, Window w, const uint4* __restrict__ text_v,
    size_t last_vec, const Pos* __restrict__ sa, int wb, int len, bool take,
    Pos lo, int cnt, int t, unsigned gmask, int& chunks) {
  const int mine = take ? cnt : 0;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < kGroup; d <<= 1) {
    const int x = __shfl_up_sync(gmask, incl, d, kGroup);
    if (t >= d) incl += x;
  }
  const int total = __shfl_sync(gmask, incl, kGroup - 1, kGroup);
  Pos* lo_s = reinterpret_cast<Pos*>(w.lo);
  lo_s[t] = lo;
  w.start[t] = incl - mine;
  w.best[t] = -1;
  __syncwarp(gmask);
  // the pair's position: the last one whose pairs start at or before q
  auto owner = [&](int q) {
    int j = 0;
#pragma unroll
    for (int s = kGroup / 2; s > 0; s >>= 1)
      if (w.start[j + s] <= q) j += s;
    return j;
  };
  // pair q's position j and suffix-array entry
  auto entry = [&](int q, int& j) {
    j = owner(q);
    return __ldg(sa + lo_s[j] + (q - w.start[j]));
  };
  int q = t, j = 0;
  Pos g = 0;
  if (q < total) g = entry(q, j);
  if constexpr (kFirstChunk) {
    auto text = [&](Pos g, uint4& v0, uint4& v1) {
      const size_t a = (size_t)g >> 4;
      v0 = __ldg(text_v + min(a, last_vec));
      v1 = __ldg(text_v + min(a + 1, last_vec));
    };
    uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
    if (q < total) text(g, v0, v1);
    int jn = 0;
    Pos gn = 0;
    if (q + kGroup < total) gn = entry(q + kGroup, jn);
    while (q < total) {
      const int qn = q + kGroup;
      uint4 n0 = v0, n1 = v1;
      if (qn < total) text(gn, n0, n1);
      int jnn = 0;
      Pos gnn = 0;
      if (qn + kGroup < total) gnn = entry(qn + kGroup, jnn);
      const int p = wb + j;
      ++chunks;
      atomicMax(&w.best[j], first_chunk_lcp(q_s, p, len - p, v0, v1,
                                             (unsigned)g & 15u));
      q = qn;
      j = jn;
      g = gn;
      v0 = n0;
      v1 = n1;
      jn = jnn;
      gn = gnn;
    }
  } else {
    while (q < total) {
      const int qn = q + kGroup;
      int jn = 0;
      Pos gn = 0;
      if (qn < total) gn = entry(qn, jn);
      const int p = wb + j;
      atomicMax(&w.best[j], walk_lcp<Pos>(q_s, p, len - p, text_v, last_vec,
                                          g, INT_MAX, chunks));
      q = qn;
      j = jn;
      g = gn;
    }
  }
  __syncwarp(gmask);
}

// The largest LCP of read bytes [i, len) against the cnt candidates
// sa[lo, lo + cnt), each LCP left in lcp_s[c], by walking compares: the
// prefix scan's compare at a hit.
template <typename Pos>
__device__ __forceinline__ int warp_walk_lstar(
    const uint32_t* q_s, int* lcp_s, const uint4* __restrict__ text_v,
    size_t last_vec, const Pos* __restrict__ sa, int i, int len, Pos lo,
    int cnt, int t, unsigned gmask, int& chunks) {
  int best = -1;
  for (int c = t; c < cnt; c += kGroup) {
    const int l = walk_lcp<Pos>(q_s, i, len - i, text_v, last_vec,
                                __ldg(sa + lo + c), INT_MAX, chunks);
    lcp_s[c] = l;
    best = max(best, l);
  }
  __syncwarp(gmask);
  return __reduce_max_sync(gmask, best);
}

// Adds the group's chunk counts to `chunks_read` (when not null).
__device__ __forceinline__ void count_chunks(unsigned long long* chunks_read,
                                             int chunks, int t,
                                             unsigned gmask) {
  if (chunks_read == nullptr) return;
  const int n = __reduce_add_sync(gmask, chunks);
  if (t == 0) atomicAdd(chunks_read, (unsigned long long)n);
}

template <typename Pos, bool kPrefix>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mmp_scan_kernel(const uint8_t* __restrict__ codes,   // (n_lanes, L)
                const int32_t* __restrict__ pw,      // (n_lanes, L)
                const int32_t* __restrict__ lens,    // (n_lanes,)
                int n_lanes, int L,
                const uint32_t* __restrict__ text_w, // text as 32-bit words
                size_t last_word,                    // last whole word of it
                const Pos* __restrict__ sa,          // (n_text,)
                const int4* __restrict__ ht,         // (S, 4) int4 rows
                const int32_t* __restrict__ ht_hi,   // (S, 4); 64-bit only
                const int32_t* __restrict__ txp_of_pos,
                const Pos* __restrict__ txp_offsets,
                int k, int C, int M, int max_steps, uint32_t hmask,
                int ht_probes, int skip_jump,
                const Pos* __restrict__ table_lo,    // prefix route only
                const uint32_t* __restrict__ packed, // prefix route only
                int pbits,                           // prefix route only
                int32_t* __restrict__ out_txp,       // (n_lanes, M*C)
                int32_t* __restrict__ out_pos,       // (n_lanes, M*C)
                uint8_t* __restrict__ out_vld,       // (n_lanes, M*C)
                int32_t* __restrict__ meta,          // (n_lanes, 4)
                unsigned long long* rows_read,       // nullptr: not counted
                unsigned long long* chunks_read,     // prefix route only
                int32_t* __restrict__ stamps) {      // nullptr: not written
  extern __shared__ uint4 smem[];
  const int slot = threadIdx.x / kGroup;          // the lane within the block
  const int t = threadIdx.x & (kGroup - 1);       // the thread within the lane
  const int gbase = threadIdx.x & 31 & ~(kGroup - 1);
  const unsigned gmask = low_bits(kGroup) << gbase;
  const int lane = blockIdx.x * kLanesPerBlock + slot;
  if (lane >= n_lanes) return;  // uniform across the group

  uint8_t* sm = reinterpret_cast<uint8_t*>(smem) +
                (size_t)slot * (kPrefix ? prefix_smem_bytes(L, C)
                                        : lane_smem_bytes(L, C));
  uint32_t* pw_s = reinterpret_cast<uint32_t*>(sm);
  uint32_t* q_s = reinterpret_cast<uint32_t*>(sm + 4 * L);
  int* lcp_s = reinterpret_cast<int*>(sm + 4 * L + round16(L + kReadPad));
  // the prefix route's window-wide compare, behind the k-mer route's layout
  const Window win(sm + lane_smem_bytes(L, C));
  const uint4* text_v = reinterpret_cast<const uint4*>(text_w);
  const size_t last_vec = (last_word + 1) / 4 - 1;
  int chunks = 0;

  const int len = load_lane(codes, pw, lens, lane, L, t, pw_s, q_s, gmask);

  const unsigned key1_shift = 2u * (32u - (unsigned)k);
  const size_t row = (size_t)lane * M * C;

  int i = 0, nm = 0, steps = 0, over = 0, mlen = 0;
  // the step of the lane's first overflow, kept for `stamps` only
  int over_step = -1;
  const size_t srow = (size_t)lane * (M + 1);
  // the window: positions [wb, wb + ww); thread t holds position wb + t
  int wb = 0, ww = 0;
  bool w_found = false;
  Pos w_lo = 0;
  int w_cnt = 0;
  // prefix route: window positions compared so far, and thread t's
  // position not settled by its window pass
  int w_done = 0;
  bool w_open = false;
  while (i + k <= len && nm < M && steps < max_steps) {
    if (i >= wb + ww) {
      wb = i;
      ww = min(steps == 0 ? min(kFirstWindow, kGroup) : kGroup,
               min(len - k - i + 1, max_steps - steps));
      w_found = false;
      w_cnt = 0;
      w_done = 0;
      w_open = false;
      int rows = 0;
      if (t < ww) {
        if constexpr (kPrefix) {
          rows = prefix_seed<Pos>(reinterpret_cast<const uint8_t*>(q_s),
                                  pw_s, wb + t, len, k, C, sa, table_lo,
                                  packed, pbits, w_found, w_lo, w_cnt);
        } else {
          // pw_s[i + 16] stays in the row: i + k <= len <= L and k >= 17
          const uint32_t key0 = pw_s[wb + t];
          const uint32_t key1 = pw_s[wb + t + 16] >> key1_shift;
          rows = probe<Pos>(ht, ht_hi, key0, key1, hmask, ht_probes, w_found,
                            w_lo, w_cnt);
        }
      }
      if (rows_read != nullptr) {
        rows = __reduce_add_sync(gmask, rows);
        if (t == 0) atomicAdd(rows_read, (unsigned long long)rows);
      }
    }
    const int off = i - wb;
    int lim = ww;  // the window positions known to the consume below
    if constexpr (kPrefix) {
      // chunk 0 of every candidate of the next kPart positions from i,
      // once the scan reaches them (an advance past a hit skips the rest
      // uncompared): it settles most positions, whose candidates share
      // only the seed's bases with the read
      if (off >= w_done) {
        w_done = min(off + kPart, ww);
        const bool part = t >= off && t < w_done;
        window_compare<Pos, true>(q_s, win, text_v, last_vec, sa, wb, len,
                                  part && w_found && w_cnt <= C, w_lo, w_cnt,
                                  t, gmask, chunks);
        // chunk 0's largest LCP is the position's when no candidate
        // matched chunk 0 whole or the read ends inside it; below k it is
        // no hit, which the scan consumes as a miss: one step, advance 1
        const int b = win.best[t];
        if (part)
          w_open = w_found && w_cnt <= C &&
                   !((b < 16 || len - wb - t <= 16) && b < k);
      }
      lim = w_done;
    }
    // consume the window from i on, in the sequential order: everything
    // before the first k-mer found with cnt <= C (on the prefix route,
    // not settled without a hit) is a miss or an overflow
    const unsigned ahead = ~low_bits(off);
    bool open;
    if constexpr (kPrefix)
      open = w_open;
    else
      open = w_found && w_cnt <= C;
    const unsigned candm = (__ballot_sync(gmask, open) >> gbase) & ahead;
    const unsigned overm =
        (__ballot_sync(gmask, w_found && w_cnt > C) >> gbase) & ahead;
    const int p = candm ? __ffs((int)candm) - 1 : lim;
    // the positions off .. p - 1 take steps steps .. steps + p - off - 1:
    // the first overflow is the lowest overflow bit at or above off
    // (`ahead`), not the window's end
    if (stamps != nullptr && !over && (overm & low_bits(p)))
      over_step = steps + (__ffs((int)(overm & low_bits(p))) - 1) - off;
    steps += p - off;
    if (overm & low_bits(p)) over = 1;
    i = wb + p;
    if (p == lim) continue;

    // position i: a k-mer with cnt <= C candidates
    ++steps;
    const Pos lo = __shfl_sync(gmask, w_lo, p, kGroup);
    const int cnt = __shfl_sync(gmask, w_cnt, p, kGroup);
    int lstar;
    if constexpr (kPrefix) {
      // a hit, or a position that may be one: every candidate walked, its
      // LCP kept for the slots
      lstar = warp_walk_lstar<Pos>(q_s, lcp_s, text_v, last_vec, sa, i, len,
                                   lo, cnt, t, gmask, chunks);
    } else {
      lstar = warp_lstar<Pos>(q_s, lcp_s, text_w, last_word, sa, i, len, lo,
                              cnt, t, gmask);
    }
    if (lstar >= k) {
      // candidates and the zeros behind them up to a multiple of 32 slots
      // by 4-byte stores, the rest of the MMP's C slots by group_zero
      const size_t base = row + (size_t)nm * C;
      const int cend = min(C, (cnt + 31) & ~31);
      for (int c = t; c < cend; c += kGroup) {
        int tx = 0, ps = 0;
        uint8_t vl = 0;
        if (c < cnt) {
          const Pos g = __ldg(sa + lo + c);
          tx = __ldg(txp_of_pos + g);
          // an in-transcript position: a transcript is shorter than 2^31
          ps = (int)(g - __ldg(txp_offsets + tx) - i);
          vl = (lcp_s[c] == lstar) ? 1 : 0;
        }
        out_txp[base + c] = tx;
        out_pos[base + c] = ps;
        out_vld[base + c] = vl;
      }
      if (cend < C) {
        const size_t nz = (size_t)(C - cend);
        group_zero(reinterpret_cast<uint8_t*>(out_txp + base + cend), 4 * nz,
                   t);
        group_zero(reinterpret_cast<uint8_t*>(out_pos + base + cend), 4 * nz,
                   t);
        group_zero(out_vld + base + cend, nz, t);
      }
      if (nm == 0) mlen = lstar;
      // MMP nm was found at step steps - 1 (the step counted above)
      if (stamps != nullptr && t == 0)
        stamps[srow + nm] = steps - 1;
      ++nm;
      i += skip_jump ? (lstar + 1) : max(1, lstar - k + 1);
    } else {
      ++i;
    }
    __syncwarp(gmask);
  }
  // the MMPs this lane did not find
  if (nm < M) {
    const size_t base = row + (size_t)nm * C;
    const size_t nz = (size_t)(M - nm) * C;
    group_zero(reinterpret_cast<uint8_t*>(out_txp + base), 4 * nz, t);
    group_zero(reinterpret_cast<uint8_t*>(out_pos + base), 4 * nz, t);
    group_zero(out_vld + base, nz, t);
  }
  if (t == 0)
    reinterpret_cast<int4*>(meta)[lane] = make_int4(nm, over, mlen, steps);
  if (stamps != nullptr) {
    // -1 in the slots of the MMPs not found; slot M: the first overflow
    for (int m = nm + t; m < M; m += kGroup)
      stamps[srow + m] = -1;
    if (t == 0) stamps[srow + M] = over_step;
  }
  if constexpr (kPrefix) count_chunks(chunks_read, chunks, t, gmask);
}

// The prefix route's interval at position p at a refinement level chosen
// from the sizes over all shards: bit 0 refines at depth 0, bit 1 then at
// depth 16.
template <typename Pos>
__device__ __forceinline__ void prefix_at_level(
    const uint32_t* pw_s, int p, int level, const Pos* __restrict__ sa,
    const Pos* __restrict__ table_lo, const uint32_t* __restrict__ packed,
    int pbits, Pos& lo, int& cnt) {
  Pos hi;
  coarse<Pos>(table_lo, pw_s[p], pbits, lo, hi);
  int reads = 0;
  if (level & 1) refine<Pos>(sa, packed, pw_s[p], 0, lo, hi, reads);
  if (level & 2) refine<Pos>(sa, packed, pw_s[p + 16], 16, lo, hi, reads);
  cnt = clamp_int((long long)(hi - lo));
}

// The prefix route's first facts pass at position p: (coarse size or -1
// when the first P bases hold an N, the depth-0 refinement's nhi - nlo,
// the depth-16 refinement's of the coarse interval, and of the depth-0
// one), kNoRefine where the lane has no 16 clean bases at that depth.
template <typename Pos>
__device__ __forceinline__ int4 prefix_sizes(
    const uint8_t* q8, const uint32_t* pw_s, int p, int len,
    const Pos* __restrict__ sa, const Pos* __restrict__ table_lo,
    const uint32_t* __restrict__ packed, int pbits) {
  int4 f = make_int4(-1, kNoRefine, kNoRefine, kNoRefine);
  if (!acgt(q8, p, pbits)) return f;
  Pos lo, hi;
  coarse<Pos>(table_lo, pw_s[p], pbits, lo, hi);
  f.x = clamp_int((long long)(hi - lo));
  int reads = 0;
  Pos lo0 = lo, hi0 = hi;
  const bool d0 = p + 16 <= len && acgt(q8, p, 16);
  if (d0)
    f.y = clamp_int(refine<Pos>(sa, packed, pw_s[p], 0, lo0, hi0, reads));
  if (p + 32 <= len && acgt(q8, p + 16, 16)) {
    Pos lo1 = lo, hi1 = hi;
    f.z = clamp_int(refine<Pos>(sa, packed, pw_s[p + 16], 16, lo1, hi1,
                                reads));
    f.w = d0 ? clamp_int(refine<Pos>(sa, packed, pw_s[p + 16], 16, lo0, hi0,
                                     reads))
             : f.z;
  }
  return f;
}

// The facts of every position of every lane on one shard, one warp a lane,
// windows of 32 positions (thread t seeds position wb + t).  Per position
// p of the row, with -1 where p + k > len:
//   k-mer route: int2 (cnt of the k-mer found, -1 if none; the largest
//     LCP of its candidates when 0 < cnt <= C, else -1);
//   prefix route, `level` null: int4 of prefix_sizes;
//   prefix route, `level` given (n_lanes, L): where level >= 0 the
//     largest LCP over the interval at that level, else -1.
template <typename Pos, bool kPrefix>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
facts_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ pw,
             const int32_t* __restrict__ lens, int n_lanes, int L,
             const uint32_t* __restrict__ text_w, size_t last_word,
             const Pos* __restrict__ sa, const int4* __restrict__ ht,
             const int32_t* __restrict__ ht_hi,
             const Pos* __restrict__ table_lo,
             const uint32_t* __restrict__ packed, int pbits, int k, int C,
             uint32_t hmask, int ht_probes,
             const int8_t* __restrict__ level, int32_t* __restrict__ out,
             unsigned long long* chunks_read) {   // nullptr: not counted
  extern __shared__ uint4 smem[];
  const int slot = threadIdx.x / kGroup;
  const int t = threadIdx.x & (kGroup - 1);
  const int gbase = threadIdx.x & 31 & ~(kGroup - 1);
  const unsigned gmask = low_bits(kGroup) << gbase;
  const int lane = blockIdx.x * kLanesPerBlock + slot;
  if (lane >= n_lanes) return;
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem) +
                (size_t)slot * facts_smem_bytes(L);
  uint32_t* pw_s = reinterpret_cast<uint32_t*>(sm);
  uint32_t* q_s = reinterpret_cast<uint32_t*>(sm + 4 * L);
  const Window win(sm + 4 * L + round16(L + kReadPad));
  const uint4* text_v = reinterpret_cast<const uint4*>(text_w);
  const size_t last_vec = (last_word + 1) / 4 - 1;
  int chunks = 0;
  const int len = load_lane(codes, pw, lens, lane, L, t, pw_s, q_s, gmask);
  const uint8_t* q8 = reinterpret_cast<const uint8_t*>(q_s);
  const unsigned key1_shift = 2u * (32u - (unsigned)k);
  const size_t row = (size_t)lane * L;

  for (int wb = 0; wb < L; wb += kGroup) {
    const int p = wb + t;
    const bool live = p < L && p + k <= len;
    if constexpr (kPrefix) {
      if (level == nullptr) {  // uniform across the warp
        if (p < L)
          reinterpret_cast<int4*>(out)[row + p] =
              live ? prefix_sizes<Pos>(q8, pw_s, p, len, sa, table_lo, packed,
                                       pbits)
                   : make_int4(-1, kNoRefine, kNoRefine, kNoRefine);
        continue;
      }
    }
    bool found = false;
    Pos lo = 0;
    int cnt = 0;
    if (live) {
      if constexpr (kPrefix) {
        const int lv = level[row + p];
        if (lv >= 0) {
          prefix_at_level<Pos>(pw_s, p, lv, sa, table_lo, packed, pbits, lo,
                               cnt);
          found = true;
        }
      } else {
        probe<Pos>(ht, ht_hi, pw_s[p], pw_s[p + 16] >> key1_shift, hmask,
                   ht_probes, found, lo, cnt);
      }
    }
    // every found position's largest LCP, in one pass over the window
    window_compare<Pos, false>(q_s, win, text_v, last_vec, sa, wb, len,
                               found && cnt > 0 && cnt <= C, lo, cnt, t,
                               gmask, chunks);
    const int mine = win.best[t];
    if (p < L) {
      if constexpr (kPrefix)
        out[row + p] = mine;
      else
        reinterpret_cast<int2*>(out)[row + p] =
            make_int2(found ? cnt : -1, mine);
    }
    __syncwarp(gmask);  // the next window refills win
  }
  count_chunks(chunks_read, chunks, t, gmask);
}

// The sequential advance rule of each lane: step budget, overflow, the MMP
// count, the first MMP's length and each MMP's position and length.  One
// thread a lane.  Two input modes (`kShards`):
//   - plane: the merged facts `gfact` (n_lanes, L) int32: kOverflow, or
//     the largest LCP over all shards (-1 for a miss);
//   - shards: the S per-shard facts (n_lanes, L, 2) int32 of the k-mer
//     route, (count, largest LCP) as facts_kernel writes them, through a
//     device array of S row pointers; the merge (map/facts.py FactsMerge
//     and gfact) happens at the positions the advance visits: found when
//     any count is >= 0, the size the sum of the counts above 0
//     (saturated at C + 1: only "> 0" and "> C" matter), the LCP the
//     largest over the shards.
// A thread holds one 32-byte sector of its row (shards mode: of each of
// the S rows) in registers, loaded as two 16-byte vectors: 4 positions of
// int2 facts (the S shards' loads issued together) or 8 of the plane.  It
// consumes positions there and loads the next sector only when the
// advance leaves the one it holds; the advance never goes back.  Every
// position up to the sector's next hit advances by 1 (a miss or an
// overflow), so a bit mask of the sector's hits and one of its overflows
// let a thread take that run in one step; a lane that maps nowhere then
// costs a step a sector, not a step a position.  The first 4 MMPs stay in
// registers and are stored as 16-byte vectors when M = 4 (the CLI's).
template <bool kShards>
__device__ __forceinline__ void replay_sector(
    const int32_t* __restrict__ gfact,
    const unsigned long long* __restrict__ shard_rows, int n_shards, int C,
    size_t at, int (&x)[kShards ? 4 : 8]) {
  if constexpr (!kShards) {
    const int4* p = reinterpret_cast<const int4*>(gfact + at);
    const int4 a = __ldg(p), b = __ldg(p + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    bool found[4] = {false, false, false, false};
    int size[4] = {0, 0, 0, 0};
    int best[4] = {INT_MIN, INT_MIN, INT_MIN, INT_MIN};
    const int cap = C + 1;
    for (int s0 = 0; s0 < n_shards; s0 += 4) {
      int4 a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < n_shards) {
          const int4* p = reinterpret_cast<const int4*>(
              reinterpret_cast<const int32_t*>(__ldg(shard_rows + s0 + u)) +
              2 * at);
          a[u] = __ldg(p);
          b[u] = __ldg(p + 1);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < n_shards) {
          const int cnt[4] = {a[u].x, a[u].z, b[u].x, b[u].z};
          const int lcp[4] = {a[u].y, a[u].w, b[u].y, b[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            found[j] |= cnt[j] >= 0;
            size[j] = min(size[j] + min(max(cnt[j], 0), cap), cap);
            best[j] = max(best[j], lcp[j]);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = !found[j] ? -1
             : size[j] > C ? kOverflow
             : size[j] > 0 ? best[j]
                           : -1;
  }
}

template <bool kShards>
__global__ void __launch_bounds__(128)
replay_kernel(const int32_t* __restrict__ gfact,
              const unsigned long long* __restrict__ shard_rows,
              int n_shards, int C, const int32_t* __restrict__ lens,
              int n_lanes, int L, int k, int M, int max_steps, int skip_jump,
              int32_t* __restrict__ hits, int32_t* __restrict__ hit_len,
              int32_t* __restrict__ meta) {
  constexpr int W = kShards ? 4 : 8;  // positions of a 32-byte sector
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const int len = min(__ldg(lens + lane), L);
  const size_t row = (size_t)lane * L;
  int32_t* h = hits + (size_t)lane * M;
  int32_t* hl = hit_len + (size_t)lane * M;
  int x[W];
  unsigned hit_m = 0, over_m = 0;  // the sector's hits and overflows
  int held = -W;  // first position of the sector in x
  int hr[4] = {-1, -1, -1, -1}, lr[4] = {-1, -1, -1, -1};
  int i = 0, nm = 0, steps = 0, over = 0, mlen = 0;
  while (i + k <= len && nm < M && steps < max_steps) {
    if (i >= held + W) {
      held = i & ~(W - 1);
      replay_sector<kShards>(gfact, shard_rows, n_shards, C, row + held, x);
      hit_m = over_m = 0;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        hit_m |= (unsigned)(x[j] >= k) << j;
        over_m |= (unsigned)(x[j] == kOverflow) << j;
      }
    }
    // the positions up to the sector's next hit, the lane's last and the
    // step budget advance by 1 each: consume them at once
    const int o = i - held;
    const int lim = min(min(W, len - k + 1 - held), o + (max_steps - steps));
    const unsigned ahead = hit_m >> o;
    const int stop = min(ahead ? o + __ffs(ahead) - 1 : W, lim);
    if (stop > o) {
      if ((over_m >> o) & ((1u << (stop - o)) - 1)) over = 1;
      steps += stop - o;
      i = held + stop;
      continue;
    }
    // a hit at i
    int v = x[0];
#pragma unroll
    for (int j = 1; j < W; ++j)
      if (o == j) v = x[j];
    ++steps;
    if (nm < 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nm == j) {
          hr[j] = i;
          lr[j] = v;
        }
    } else {
      h[nm] = i;
      hl[nm] = v;
    }
    if (nm == 0) mlen = v;
    ++nm;
    i += skip_jump ? (v + 1) : max(1, v - k + 1);
  }
  if (M == 4) {
    reinterpret_cast<int4*>(hits)[lane] = make_int4(hr[0], hr[1], hr[2],
                                                    hr[3]);
    reinterpret_cast<int4*>(hit_len)[lane] = make_int4(lr[0], lr[1], lr[2],
                                                       lr[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < M) {
        h[j] = hr[j];
        hl[j] = lr[j];
      }
    for (int m = max(nm, 4); m < M; ++m) h[m] = hl[m] = -1;
  }
  reinterpret_cast<int4*>(meta)[lane] = make_int4(nm, over, mlen, steps);
}

// On one shard, the slots of the replayed MMPs, as the scan writes them:
// MMP m < nm (meta column 0) at position hits[m] gets its candidates on
// this shard in slots m*C + c (transcript id + txp_base, in-transcript
// position - hits[m], valid when the LCP equals hit_len[m]), zeros
// behind them and in the slots of MMPs the lane did not find.  At a hit
// the interval holds at most C suffixes over all shards; the clamp keeps
// the writes inside the row whatever the inputs.
template <typename Pos, bool kPrefix>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
slots_kernel(const uint8_t* __restrict__ codes, const int32_t* __restrict__ pw,
             const int32_t* __restrict__ lens, int n_lanes, int L,
             const uint32_t* __restrict__ text_w, size_t last_word,
             const Pos* __restrict__ sa, const int4* __restrict__ ht,
             const int32_t* __restrict__ ht_hi,
             const Pos* __restrict__ table_lo,
             const uint32_t* __restrict__ packed, int pbits,
             const int32_t* __restrict__ txp_of_pos,
             const Pos* __restrict__ txp_offsets, int txp_base, int k, int C,
             int M, uint32_t hmask, int ht_probes,
             const int8_t* __restrict__ level,
             const int32_t* __restrict__ hits,
             const int32_t* __restrict__ hit_len,
             const int32_t* __restrict__ rmeta,
             int32_t* __restrict__ out_txp, int32_t* __restrict__ out_pos,
             uint8_t* __restrict__ out_vld) {
  extern __shared__ uint4 smem[];
  const int slot = threadIdx.x / kGroup;
  const int t = threadIdx.x & (kGroup - 1);
  const int gbase = threadIdx.x & 31 & ~(kGroup - 1);
  const unsigned gmask = low_bits(kGroup) << gbase;
  const int lane = blockIdx.x * kLanesPerBlock + slot;
  if (lane >= n_lanes) return;
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem) +
                (size_t)slot * lane_smem_bytes(L, C);
  uint32_t* pw_s = reinterpret_cast<uint32_t*>(sm);
  uint32_t* q_s = reinterpret_cast<uint32_t*>(sm + 4 * L);
  int* lcp_s = reinterpret_cast<int*>(sm + 4 * L + round16(L + kReadPad));
  const int len = load_lane(codes, pw, lens, lane, L, t, pw_s, q_s, gmask);
  const unsigned key1_shift = 2u * (32u - (unsigned)k);
  const int nm = rmeta[(size_t)lane * 4];

  for (int m = 0; m < M; ++m) {
    const size_t base = ((size_t)lane * M + m) * C;
    int p = 0, cnt = 0, want = -1;
    Pos lo = 0;
    if (m < nm) {
      p = hits[(size_t)lane * M + m];
      want = hit_len[(size_t)lane * M + m];
      if (t == 0) {
        if constexpr (kPrefix) {
          prefix_at_level<Pos>(pw_s, p, level[(size_t)lane * L + p], sa,
                               table_lo, packed, pbits, lo, cnt);
        } else {
          bool found;
          probe<Pos>(ht, ht_hi, pw_s[p], pw_s[p + 16] >> key1_shift, hmask,
                     ht_probes, found, lo, cnt);
          if (!found) cnt = 0;
        }
      }
      lo = __shfl_sync(gmask, lo, 0, kGroup);
      cnt = min(__shfl_sync(gmask, cnt, 0, kGroup), C);
      if (cnt > 0)
        warp_lstar<Pos>(q_s, lcp_s, text_w, last_word, sa, p, len, lo, cnt, t,
                        gmask);
    }
    for (int c = t; c < C; c += kGroup) {
      int tx = 0, ps = 0;
      uint8_t vl = 0;
      if (c < cnt) {
        const Pos g = __ldg(sa + lo + c);
        const int tl = __ldg(txp_of_pos + g);
        ps = (int)(g - __ldg(txp_offsets + tl) - p);
        tx = tl + txp_base;
        vl = lcp_s[c] == want ? 1 : 0;
      }
      out_txp[base + c] = tx;
      out_pos[base + c] = ps;
      out_vld[base + c] = vl;
    }
    __syncwarp(gmask);
  }
}

// Sets the dynamic shared memory of `kernel` for `lane_bytes` a lane (the
// *_smem_bytes above); returns its bytes, or -1 with `err` set.
template <typename Kernel>
int lane_smem(Kernel kernel, int lane_bytes, cudaError_t& err) {
  // above 48 KB only by opt-in (a capacity the card cannot hold fails
  // here, with the CUDA error)
  const int smem = kLanesPerBlock * lane_bytes;
  err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return -1;
  }
  return smem;
}

uint32_t hash_mask(int ht_bits) {
  return (ht_bits >= 32) ? 0xFFFFFFFFu : ((1u << ht_bits) - 1u);
}

// Launches the scan of one width and route on `stream` of `device`; see
// the C interface below.
template <typename Pos, bool kPrefix>
int launch_scan(const void* codes, const void* pw, const void* lens,
                int n_lanes, int L, const void* text, long long text_bytes,
                const void* sa, const void* ht, const void* ht_hi,
                const void* table_lo, const void* packed, int pbits,
                const void* txp_of_pos, const void* txp_offsets, int k,
                int C, int M, int max_steps, int ht_bits, int ht_probes,
                int skip_jump, void* out_txp, void* out_pos, void* out_vld,
                void* meta, void* rows_read, void* chunks_read,
                void* stamps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0) return 0;
  if (L % 8 != 0 || text_bytes < 4) return (int)cudaErrorInvalidValue;
  // the prefix route reads the text as aligned 16-byte vectors
  if (kPrefix && ((uintptr_t)text % 16 != 0 || text_bytes < 16))
    return (int)cudaErrorInvalidValue;
  const int smem = lane_smem(mmp_scan_kernel<Pos, kPrefix>,
                             kPrefix ? prefix_smem_bytes(L, C)
                                     : lane_smem_bytes(L, C),
                             err);
  if (smem < 0) return (int)err;
  const dim3 grid((n_lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  mmp_scan_kernel<Pos, kPrefix><<<grid, kWarpsPerBlock * 32, smem,
                                  (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)pw, (const int32_t*)lens,
      n_lanes, L, (const uint32_t*)text, (size_t)(text_bytes / 4 - 1),
      (const Pos*)sa, (const int4*)ht, (const int32_t*)ht_hi,
      (const int32_t*)txp_of_pos, (const Pos*)txp_offsets, k, C, M,
      max_steps, hash_mask(ht_bits), ht_probes, skip_jump,
      (const Pos*)table_lo, (const uint32_t*)packed, pbits,
      (int32_t*)out_txp, (int32_t*)out_pos, (uint8_t*)out_vld,
      (int32_t*)meta, (unsigned long long*)rows_read,
      (unsigned long long*)chunks_read, (int32_t*)stamps);
  return (int)cudaGetLastError();
}

template <typename Pos, bool kPrefix>
int launch_facts(const void* codes, const void* pw, const void* lens,
                 int n_lanes, int L, const void* text, long long text_bytes,
                 const void* sa, const void* ht, const void* ht_hi,
                 const void* table_lo, const void* packed, int pbits, int k,
                 int C, int ht_bits, int ht_probes, const void* level,
                 void* out, void* chunks_read, void* stream) {
  cudaError_t err;
  const int smem = lane_smem(facts_kernel<Pos, kPrefix>, facts_smem_bytes(L),
                             err);
  if (smem < 0) return (int)err;
  const dim3 grid((n_lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  facts_kernel<Pos, kPrefix><<<grid, kWarpsPerBlock * 32, smem,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)pw, (const int32_t*)lens,
      n_lanes, L, (const uint32_t*)text, (size_t)(text_bytes / 4 - 1),
      (const Pos*)sa, (const int4*)ht, (const int32_t*)ht_hi,
      (const Pos*)table_lo, (const uint32_t*)packed, pbits, k, C,
      hash_mask(ht_bits), ht_probes, (const int8_t*)level, (int32_t*)out,
      (unsigned long long*)chunks_read);
  return (int)cudaGetLastError();
}

template <typename Pos, bool kPrefix>
int launch_slots(const void* codes, const void* pw, const void* lens,
                 int n_lanes, int L, const void* text, long long text_bytes,
                 const void* sa, const void* ht, const void* ht_hi,
                 const void* table_lo, const void* packed, int pbits,
                 const void* txp_of_pos, const void* txp_offsets,
                 int txp_base, int k, int C, int M, int ht_bits,
                 int ht_probes, const void* level, const void* hits,
                 const void* hit_len, const void* rmeta, void* out_txp,
                 void* out_pos, void* out_vld, void* stream) {
  cudaError_t err;
  const int smem = lane_smem(slots_kernel<Pos, kPrefix>,
                             lane_smem_bytes(L, C), err);
  if (smem < 0) return (int)err;
  const dim3 grid((n_lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  slots_kernel<Pos, kPrefix><<<grid, kWarpsPerBlock * 32, smem,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)pw, (const int32_t*)lens,
      n_lanes, L, (const uint32_t*)text, (size_t)(text_bytes / 4 - 1),
      (const Pos*)sa, (const int4*)ht, (const int32_t*)ht_hi,
      (const Pos*)table_lo, (const uint32_t*)packed, pbits,
      (const int32_t*)txp_of_pos, (const Pos*)txp_offsets, txp_base, k, C,
      M, hash_mask(ht_bits), ht_probes, (const int8_t*)level,
      (const int32_t*)hits, (const int32_t*)hit_len, (const int32_t*)rmeta,
      (int32_t*)out_txp, (int32_t*)out_pos, (uint8_t*)out_vld);
  return (int)cudaGetLastError();
}

template <bool kShards>
int launch_replay(const void* gfact, const void* shard_rows, int n_shards,
                  int C, const void* lens, int n_lanes, int L, int k, int M,
                  int max_steps, int skip_jump, void* hits, void* hit_len,
                  void* meta, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0) return 0;
  if (L % 8 != 0 || M < 1) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 128;
  replay_kernel<kShards><<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)gfact, (const unsigned long long*)shard_rows, n_shards,
      C, (const int32_t*)lens, n_lanes, L, k, M, max_steps, skip_jump,
      (int32_t*)hits, (int32_t*)hit_len, (int32_t*)meta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the scan on `stream` (a cudaStream_t) of `device`.  The kernel
// writes every slot of the four outputs, which may be uninitialised.
// `text` holds `text_bytes` bytes: the text and its trailing padding.
// `rows_read`, when not null, points at a 64-bit device counter to which
// the kernel adds the table rows it reads.  pw, codes and meta must be
// 16-byte aligned and L a multiple of 8.  Returns the cudaError_t of the
// launch (0 = success).  sa and txp_offsets are int32.  `stamps`, when not
// null, is (n_lanes, M + 1) int32, written whole: the step of each MMP
// found, -1 for those not found, and in slot M the step of the lane's
// first overflow or -1 (every scan entry point takes the same argument
// before `device`).
int sf_mmp_scan(const void* codes, const void* pw, const void* lens,
                int n_lanes, int L, const void* text, long long text_bytes,
                const void* sa, const void* ht, const void* txp_of_pos,
                const void* txp_offsets, int k, int C, int M, int max_steps,
                int ht_bits, int ht_probes, int skip_jump, void* out_txp,
                void* out_pos, void* out_vld, void* meta, void* rows_read,
                void* stamps, int device, void* stream) {
  return launch_scan<int32_t, false>(
      codes, pw, lens, n_lanes, L, text, text_bytes, sa, ht, nullptr,
      nullptr, nullptr, 0, txp_of_pos, txp_offsets, k, C, M, max_steps,
      ht_bits, ht_probes, skip_jump, out_txp, out_pos, out_vld, meta,
      rows_read, nullptr, stamps, device, stream);
}

// The same for a 64-bit index: sa and txp_offsets are int64, the lo
// words of `ht` hold the low 32 bits of each entry's lo, and `ht_hi`
// (2^ht_bits rows of 4 int32) the high 32 bits.
int sf_mmp_scan64(const void* codes, const void* pw, const void* lens,
                  int n_lanes, int L, const void* text, long long text_bytes,
                  const void* sa, const void* ht, const void* ht_hi,
                  const void* txp_of_pos, const void* txp_offsets, int k,
                  int C, int M, int max_steps, int ht_bits, int ht_probes,
                  int skip_jump, void* out_txp, void* out_pos, void* out_vld,
                  void* meta, void* rows_read, void* stamps, int device,
                  void* stream) {
  return launch_scan<long long, false>(
      codes, pw, lens, n_lanes, L, text, text_bytes, sa, ht, ht_hi, nullptr,
      nullptr, 0, txp_of_pos, txp_offsets, k, C, M, max_steps, ht_bits,
      ht_probes, skip_jump, out_txp, out_pos, out_vld, meta, rows_read,
      nullptr, stamps, device, stream);
}

// The prefix route (an index without a k-mer table): `table_lo` holds the
// 4^pbits + 1 interval starts and `packed` the A-substituted 16-base words
// of the text with 512 words of zeros behind it.  `rows_read` counts the
// table entries and search steps read; `chunks_read`, when not null, a
// 64-bit device counter, the 16-byte text chunks the compare reads.
// `text` must be 16-byte aligned.  sa, table_lo and txp_offsets are int32
// (sf_mmp_scan_prefix) or int64 (sf_mmp_scan_prefix64).
int sf_mmp_scan_prefix(const void* codes, const void* pw, const void* lens,
                       int n_lanes, int L, const void* text,
                       long long text_bytes, const void* sa,
                       const void* table_lo, const void* packed, int pbits,
                       const void* txp_of_pos, const void* txp_offsets, int k,
                       int C, int M, int max_steps, int skip_jump,
                       void* out_txp, void* out_pos, void* out_vld,
                       void* meta, void* rows_read, void* chunks_read,
                       void* stamps, int device, void* stream) {
  return launch_scan<int32_t, true>(
      codes, pw, lens, n_lanes, L, text, text_bytes, sa, nullptr, nullptr,
      table_lo, packed, pbits, txp_of_pos, txp_offsets, k, C, M, max_steps,
      0, 0, skip_jump, out_txp, out_pos, out_vld, meta, rows_read,
      chunks_read, stamps, device, stream);
}

int sf_mmp_scan_prefix64(const void* codes, const void* pw, const void* lens,
                         int n_lanes, int L, const void* text,
                         long long text_bytes, const void* sa,
                         const void* table_lo, const void* packed, int pbits,
                         const void* txp_of_pos, const void* txp_offsets,
                         int k, int C, int M, int max_steps, int skip_jump,
                         void* out_txp, void* out_pos, void* out_vld,
                         void* meta, void* rows_read, void* chunks_read,
                         void* stamps, int device, void* stream) {
  return launch_scan<long long, true>(
      codes, pw, lens, n_lanes, L, text, text_bytes, sa, nullptr, nullptr,
      table_lo, packed, pbits, txp_of_pos, txp_offsets, k, C, M, max_steps,
      0, 0, skip_jump, out_txp, out_pos, out_vld, meta, rows_read,
      chunks_read, stamps, device, stream);
}

// The facts mode on one shard (see facts_kernel): `pos64` selects the
// position width, `prefix` the route (then `ht`, `ht_hi` may be null;
// otherwise `table_lo`, `packed`).  `level` is null but for the prefix
// route's second pass.  `out` is (n_lanes, L, 2) int32 on the k-mer
// route, (n_lanes, L, 4) on the prefix route's first pass and (n_lanes, L)
// on its second, 16-byte aligned.  `chunks_read`, when not null, points
// at a 64-bit device counter to which the kernel adds the 16-byte text
// chunks its compare reads.  `text` must be 16-byte aligned.
int sf_mmp_facts(int pos64, int prefix, const void* codes, const void* pw,
                 const void* lens, int n_lanes, int L, const void* text,
                 long long text_bytes, const void* sa, const void* ht,
                 const void* ht_hi, const void* table_lo, const void* packed,
                 int pbits, int k, int C, int ht_bits, int ht_probes,
                 const void* level, void* out, void* chunks_read, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0) return 0;
  if (L % 8 != 0 || text_bytes < 16 || (uintptr_t)text % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(codes, pw, lens, n_lanes, L, text, text_bytes, sa, ht, ht_hi,
              table_lo, packed, pbits, k, C, ht_bits, ht_probes, level, out,
              chunks_read, stream);
  };
  if (pos64)
    return prefix ? go(launch_facts<long long, true>)
                  : go(launch_facts<long long, false>);
  return prefix ? go(launch_facts<int32_t, true>)
                : go(launch_facts<int32_t, false>);
}

// The replay (see replay_kernel) on `stream` of `device`, plane mode:
// gfact (n_lanes, L) and lens int32, hits and hit_len (n_lanes, M)
// int32, meta (n_lanes, 4) int32; every pointer 16-byte aligned and L a
// multiple of 8.
int sf_mmp_replay(const void* gfact, const void* lens, int n_lanes, int L,
                  int k, int M, int max_steps, int skip_jump, void* hits,
                  void* hit_len, void* meta, int device, void* stream) {
  return launch_replay<false>(gfact, nullptr, 0, 0, lens, n_lanes, L, k, M,
                              max_steps, skip_jump, hits, hit_len, meta,
                              device, stream);
}

// The replay in shards mode: `shard_rows` is a device array of n_shards
// pointers (64-bit) to (n_lanes, L, 2) int32 facts of the k-mer route,
// each 16-byte aligned, all on `device`; C the candidate capacity.  The
// other arguments as sf_mmp_replay's.
int sf_mmp_replay_shards(const void* shard_rows, int n_shards, int C,
                         const void* lens, int n_lanes, int L, int k, int M,
                         int max_steps, int skip_jump, void* hits,
                         void* hit_len, void* meta, int device,
                         void* stream) {
  if (n_shards < 1 || C < 0 || C > (1 << 29))
    return (int)cudaErrorInvalidValue;
  return launch_replay<true>(nullptr, shard_rows, n_shards, C, lens,
                             n_lanes, L, k, M, max_steps, skip_jump, hits,
                             hit_len, meta, device, stream);
}

// The slot mode on one shard (see slots_kernel): the replay's hits,
// hit_len and meta, `level` (the prefix route's refinement level per
// position, null on the k-mer route) and the shard's first transcript id;
// the three outputs as the scan's.
int sf_mmp_slots(int pos64, int prefix, const void* codes, const void* pw,
                 const void* lens, int n_lanes, int L, const void* text,
                 long long text_bytes, const void* sa, const void* ht,
                 const void* ht_hi, const void* table_lo, const void* packed,
                 int pbits, const void* txp_of_pos, const void* txp_offsets,
                 int txp_base, int k, int C, int M, int ht_bits,
                 int ht_probes, const void* level, const void* hits,
                 const void* hit_len, const void* rmeta, void* out_txp,
                 void* out_pos, void* out_vld, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0) return 0;
  if (L % 8 != 0 || text_bytes < 4) return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(codes, pw, lens, n_lanes, L, text, text_bytes, sa, ht, ht_hi,
              table_lo, packed, pbits, txp_of_pos, txp_offsets, txp_base, k,
              C, M, ht_bits, ht_probes, level, hits, hit_len, rmeta, out_txp,
              out_pos, out_vld, stream);
  };
  if (pos64)
    return prefix ? go(launch_slots<long long, true>)
                  : go(launch_slots<long long, false>);
  return prefix ? go(launch_slots<int32_t, true>)
                : go(launch_slots<int32_t, false>);
}

const char* sf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
