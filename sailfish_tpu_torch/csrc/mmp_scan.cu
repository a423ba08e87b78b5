// MMP scan for NVIDIA Hopper (sm_90a): one warp per oriented read lane.
//
// Replaces sailfish_tpu/map/pallas_kernel.py::_scan_kernel (launched by
// mmp_scan_pallas).  It computes what that kernel computes, not how:
// the TPU kernel's (8,128)-tile DMAs with rolls, one-code-per-i32 text
// rows, lane-phase synchronisation and candidate banks exist to satisfy
// Mosaic's tiling rules and the TPU's single scalar unit, and have no
// counterpart here.
//
// Per lane (all 32 threads keep the scalar scan state in lock step, so
// control flow stays warp-uniform):
//   while i + k <= len, nm < M, steps < max_steps:
//     probe the bucketed k-mer table with the A-substituted key of
//       read[i, i+k) (an N hashes as A), chasing up to ht_probes buckets;
//       an empty entry in a probed bucket is a miss
//     steps += 1; a miss advances i by 1
//     cnt > C: set overflow, advance 1 (no hit)
//     else the cnt candidates sa[lo + c] are striped over the 32 threads;
//       each computes its LCP against the true text codes (N in the read,
//       a separator in the text and the read end all stop a match), a
//       warp max gives lstar, and on lstar >= k the C slots of MMP nm get
//       (transcript, in-transcript position - i, lcp == lstar);
//       advance i by lstar + 1 (jump) or max(1, lstar - k + 1) (nip)
//     a found k-mer without a hit advances 1
//
// What bounds it on the card: dependent, data-driven loads — the probe
// (one 64-byte bucket row per chained bucket), the suffix-array window
// and one text line per candidate — not arithmetic.  This first version
// leans on the L1/L2 caches for them and keeps no state in shared memory
// except each warp's candidate LCPs; staging the probe and candidate
// loads ahead of use is left to later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ uint32_t mix_kmer(uint32_t k0, uint32_t k1) {
  // index/kmerhash.py mix_hash_u32
  uint32_t h = (k0 * 0x9E3779B1u) ^ (k1 * 0x85EBCA77u);
  h ^= h >> 15;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mmp_scan_kernel(const uint8_t* __restrict__ codes,   // (n_lanes, L)
                const int32_t* __restrict__ pw,      // (n_lanes, L)
                const int32_t* __restrict__ lens,    // (n_lanes,)
                int n_lanes, int L,
                const uint8_t* __restrict__ text,    // (n_text,)
                const int32_t* __restrict__ sa,      // (n_text,)
                const int4* __restrict__ ht,         // (S, 4) int4 rows
                const int32_t* __restrict__ txp_of_pos,
                const int32_t* __restrict__ txp_offsets,
                int k, int C, int M, int max_steps, uint32_t hmask,
                int ht_probes, int skip_jump,
                int32_t* __restrict__ out_txp,       // (n_lanes, M*C)
                int32_t* __restrict__ out_pos,       // (n_lanes, M*C)
                uint8_t* __restrict__ out_vld,       // (n_lanes, M*C)
                int32_t* __restrict__ meta) {        // (n_lanes, 4)
  extern __shared__ int32_t lcp_smem[];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarpsPerBlock + warp;
  if (lane >= n_lanes) return;  // uniform across the warp

  int32_t* lcp_s = lcp_smem + warp * C;
  const uint8_t* q = codes + (size_t)lane * L;
  const int32_t* w = pw + (size_t)lane * L;
  const int len = lens[lane];
  const unsigned key1_shift = 2u * (32u - (unsigned)k);
  const size_t row = (size_t)lane * M * C;

  int i = 0, nm = 0, steps = 0, over = 0, mlen = 0;
  while (i + k <= len && nm < M && steps < max_steps) {
    const uint32_t key0 = (uint32_t)w[i];
    const uint32_t key1 = ((uint32_t)w[i + 16]) >> key1_shift;
    uint32_t h = mix_kmer(key0, key1) & hmask;
    bool found = false;
    int lo = 0, cnt = 0;
    for (int p = 0; p < ht_probes; ++p) {
      const int4* b = ht + (size_t)h * 4;
      const int4 k0v = __ldg(b), k1v = __ldg(b + 1);
      const int4 lov = __ldg(b + 2), cv = __ldg(b + 3);
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
    ++steps;
    if (!found) {
      ++i;
      continue;
    }
    if (cnt > C) {
      over = 1;
      ++i;
      continue;
    }

    int best = -1;
    for (int c = t; c < cnt; c += 32) {
      const int g = __ldg(sa + lo + c);
      // text[g + (j - i)] against read[j]; the text ends in a separator,
      // so the walk never leaves it
      int j = i;
      while (j < len) {
        const uint8_t a = q[j];
        if (a > 3 || a != __ldg(text + g + (j - i))) break;
        ++j;
      }
      lcp_s[c] = j - i;
      best = max(best, j - i);
    }
    const int lstar = __reduce_max_sync(0xffffffffu, best);
    if (lstar >= k) {
      // each thread rereads only the lcp_s slots it wrote itself
      const size_t base = row + (size_t)nm * C;
      for (int c = t; c < cnt; c += 32) {
        const int g = __ldg(sa + lo + c);
        const int tx = __ldg(txp_of_pos + g);
        out_txp[base + c] = tx;
        out_pos[base + c] = g - __ldg(txp_offsets + tx) - i;
        out_vld[base + c] = (lcp_s[c] == lstar) ? 1 : 0;
      }
      if (nm == 0) mlen = lstar;
      ++nm;
      i += skip_jump ? (lstar + 1) : max(1, lstar - k + 1);
    } else {
      ++i;
    }
    __syncwarp();
  }
  if (t == 0) {
    int32_t* m = meta + (size_t)lane * 4;
    m[0] = nm;
    m[1] = over;
    m[2] = mlen;
    m[3] = steps;
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream` (a cudaStream_t) of `device`.  Outputs
// must be zero-filled by the caller (slots of MMPs a lane never found are
// not written).  Returns the cudaError_t of the launch (0 = success).
int sf_mmp_scan(const void* codes, const void* pw, const void* lens,
                int n_lanes, int L, const void* text, const void* sa,
                const void* ht, const void* txp_of_pos,
                const void* txp_offsets, int k, int C, int M, int max_steps,
                int ht_bits, int ht_probes, int skip_jump, void* out_txp,
                void* out_pos, void* out_vld, void* meta, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lanes == 0) return 0;
  // one int32 LCP per candidate per warp; above 48 KB only by opt-in (a
  // capacity the card cannot hold fails here, with the CUDA error)
  const int smem = kWarpsPerBlock * C * (int)sizeof(int32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mmp_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uint32_t hmask = (ht_bits >= 32) ? 0xFFFFFFFFu
                                         : ((1u << ht_bits) - 1u);
  const dim3 grid((n_lanes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  mmp_scan_kernel<<<grid, kWarpsPerBlock * 32, smem,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)pw, (const int32_t*)lens,
      n_lanes, L, (const uint8_t*)text, (const int32_t*)sa,
      (const int4*)ht, (const int32_t*)txp_of_pos,
      (const int32_t*)txp_offsets, k, C, M, max_steps, hmask, ht_probes,
      skip_jump, (int32_t*)out_txp, (int32_t*)out_pos, (uint8_t*)out_vld,
      (int32_t*)meta);
  return (int)cudaGetLastError();
}

const char* sf_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
