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

// Shared memory of one lane: packed words, codes (padded), candidate LCPs.
__host__ __device__ constexpr int lane_smem_bytes(int L, int C) {
  return 4 * L + round16(L + kReadPad) + round16(4 * C);
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
// its home bucket.  Returns the number of 64-byte rows read.
__device__ __forceinline__ int probe(const int4* __restrict__ ht,
                                     uint32_t key0, uint32_t key1,
                                     uint32_t hmask, int ht_probes,
                                     bool& found, int& lo, int& cnt) {
  uint32_t h = mix_kmer(key0, key1) & hmask;
  int rows = 0;
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
      }
      empty |= (ecn[e] == 0);
    }
    if (found || empty) break;
    h = (h + 1) & hmask;
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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mmp_scan_kernel(const uint8_t* __restrict__ codes,   // (n_lanes, L)
                const int32_t* __restrict__ pw,      // (n_lanes, L)
                const int32_t* __restrict__ lens,    // (n_lanes,)
                int n_lanes, int L,
                const uint32_t* __restrict__ text_w, // text as 32-bit words
                size_t last_word,                    // last whole word of it
                const int32_t* __restrict__ sa,      // (n_text,)
                const int4* __restrict__ ht,         // (S, 4) int4 rows
                const int32_t* __restrict__ txp_of_pos,
                const int32_t* __restrict__ txp_offsets,
                int k, int C, int M, int max_steps, uint32_t hmask,
                int ht_probes, int skip_jump,
                int32_t* __restrict__ out_txp,       // (n_lanes, M*C)
                int32_t* __restrict__ out_pos,       // (n_lanes, M*C)
                uint8_t* __restrict__ out_vld,       // (n_lanes, M*C)
                int32_t* __restrict__ meta,          // (n_lanes, 4)
                unsigned long long* rows_read) {     // nullptr: not counted
  extern __shared__ uint4 smem[];
  const int slot = threadIdx.x / kGroup;          // the lane within the block
  const int t = threadIdx.x & (kGroup - 1);       // the thread within the lane
  const int gbase = threadIdx.x & 31 & ~(kGroup - 1);
  const unsigned gmask = low_bits(kGroup) << gbase;
  const int lane = blockIdx.x * kLanesPerBlock + slot;
  if (lane >= n_lanes) return;  // uniform across the group

  uint8_t* sm = reinterpret_cast<uint8_t*>(smem) +
                (size_t)slot * lane_smem_bytes(L, C);
  uint32_t* pw_s = reinterpret_cast<uint32_t*>(sm);
  uint32_t* q_s = reinterpret_cast<uint32_t*>(sm + 4 * L);
  int* lcp_s = reinterpret_cast<int*>(sm + 4 * L + round16(L + kReadPad));

  // the lane's rows, once: L is a multiple of 8, so a pw row is a whole
  // number of 16-byte vectors and a codes row of 8-byte ones
  {
    const uint4* src = reinterpret_cast<const uint4*>(pw + (size_t)lane * L);
    uint4* dst = reinterpret_cast<uint4*>(pw_s);
    for (int v = t; v < L / 4; v += kGroup) dst[v] = __ldg(src + v);
    const uint2* csrc =
        reinterpret_cast<const uint2*>(codes + (size_t)lane * L);
    uint2* cdst = reinterpret_cast<uint2*>(q_s);
    for (int v = t; v < round16(L + kReadPad) / 8; v += kGroup)
      cdst[v] = v < L / 8 ? __ldg(csrc + v)
                          : make_uint2(0x04040404u, 0x04040404u);
  }
  const int len = min(lens[lane], L);
  __syncwarp(gmask);

  const unsigned key1_shift = 2u * (32u - (unsigned)k);
  const size_t row = (size_t)lane * M * C;

  int i = 0, nm = 0, steps = 0, over = 0, mlen = 0;
  // the window: positions [wb, wb + ww); thread t holds position wb + t
  int wb = 0, ww = 0;
  bool w_found = false;
  int w_lo = 0, w_cnt = 0;
  while (i + k <= len && nm < M && steps < max_steps) {
    if (i >= wb + ww) {
      wb = i;
      ww = min(steps == 0 ? min(kFirstWindow, kGroup) : kGroup,
               min(len - k - i + 1, max_steps - steps));
      w_found = false;
      w_cnt = 0;
      int rows = 0;
      if (t < ww) {
        // pw_s[i + 16] stays in the row: i + k <= len <= L and k >= 17
        const uint32_t key0 = pw_s[wb + t];
        const uint32_t key1 = pw_s[wb + t + 16] >> key1_shift;
        rows = probe(ht, key0, key1, hmask, ht_probes, w_found, w_lo, w_cnt);
      }
      if (rows_read != nullptr) {
        rows = __reduce_add_sync(gmask, rows);
        if (t == 0) atomicAdd(rows_read, (unsigned long long)rows);
      }
    }
    // consume the window from i on, in the sequential order: everything
    // before the first k-mer found with cnt <= C is a miss or an overflow
    const int off = i - wb;
    const unsigned ahead = ~low_bits(off);
    const unsigned candm =
        (__ballot_sync(gmask, w_found && w_cnt <= C) >> gbase) & ahead;
    const unsigned overm =
        (__ballot_sync(gmask, w_found && w_cnt > C) >> gbase) & ahead;
    const int p = candm ? __ffs((int)candm) - 1 : ww;
    steps += p - off;
    if (overm & low_bits(p)) over = 1;
    i = wb + p;
    if (p == ww) continue;

    // position i: a k-mer with cnt <= C candidates
    ++steps;
    const int lo = __shfl_sync(gmask, w_lo, p, kGroup);
    const int cnt = __shfl_sync(gmask, w_cnt, p, kGroup);
    const int rem = len - i;
    const int nch = (rem + 15) >> 4;
    for (int c = t; c < cnt; c += kGroup) lcp_s[c] = rem;
    __syncwarp(gmask);
    for (int pr = t; pr < cnt * nch; pr += kGroup) {
      const int c = pr / nch;
      const int ch = pr - c * nch;
      const int g = __ldg(sa + lo + c);
      const int n = first_mismatch16(q_s, i + 16 * ch, text_w,
                                     (size_t)g + 16 * ch, last_word);
      // a chunk without a mismatch bounds nothing (the next chunk, or
      // the read's end, does)
      if (n < 16) atomicMin(&lcp_s[c], 16 * ch + n);
    }
    __syncwarp(gmask);
    int best = -1;
    for (int c = t; c < cnt; c += kGroup) best = max(best, lcp_s[c]);
    const int lstar = __reduce_max_sync(gmask, best);
    if (lstar >= k) {
      // candidates and the zeros behind them up to a multiple of 32 slots
      // by 4-byte stores, the rest of the MMP's C slots by group_zero
      const size_t base = row + (size_t)nm * C;
      const int cend = min(C, (cnt + 31) & ~31);
      for (int c = t; c < cend; c += kGroup) {
        int tx = 0, ps = 0;
        uint8_t vl = 0;
        if (c < cnt) {
          const int g = __ldg(sa + lo + c);
          tx = __ldg(txp_of_pos + g);
          ps = g - __ldg(txp_offsets + tx) - i;
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
}

}  // namespace

extern "C" {

// Launches the scan on `stream` (a cudaStream_t) of `device`.  The kernel
// writes every slot of the four outputs, which may be uninitialised.
// `text` holds `text_bytes` bytes: the text and its trailing padding.
// `rows_read`, when not null, points at a 64-bit device counter to which
// the kernel adds the table rows it reads.  pw, codes and meta must be
// 16-byte aligned and L a multiple of 8.  Returns the cudaError_t of the
// launch (0 = success).
int sf_mmp_scan(const void* codes, const void* pw, const void* lens,
                int n_lanes, int L, const void* text, long long text_bytes,
                const void* sa, const void* ht, const void* txp_of_pos,
                const void* txp_offsets, int k, int C, int M, int max_steps,
                int ht_bits, int ht_probes, int skip_jump, void* out_txp,
                void* out_pos, void* out_vld, void* meta, void* rows_read,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0) return 0;
  if (L % 8 != 0 || text_bytes < 4) return (int)cudaErrorInvalidValue;
  // per lane 5 L bytes of rows, the read's padding and one int32 LCP per
  // candidate; above 48 KB only by opt-in (a capacity the card cannot
  // hold fails here, with the CUDA error)
  const int smem = kLanesPerBlock * lane_smem_bytes(L, C);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mmp_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uint32_t hmask = (ht_bits >= 32) ? 0xFFFFFFFFu
                                         : ((1u << ht_bits) - 1u);
  const dim3 grid((n_lanes + kLanesPerBlock - 1) / kLanesPerBlock);
  mmp_scan_kernel<<<grid, kWarpsPerBlock * 32, smem,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)pw, (const int32_t*)lens,
      n_lanes, L, (const uint32_t*)text, (size_t)(text_bytes / 4 - 1),
      (const int32_t*)sa, (const int4*)ht, (const int32_t*)txp_of_pos,
      (const int32_t*)txp_offsets, k, C, M, max_steps, hmask, ht_probes,
      skip_jump, (int32_t*)out_txp, (int32_t*)out_pos, (uint8_t*)out_vld,
      (int32_t*)meta, (unsigned long long*)rows_read);
  return (int)cudaGetLastError();
}

const char* sf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
