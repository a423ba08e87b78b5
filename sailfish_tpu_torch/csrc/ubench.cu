// Op-chain microbenchmark for NVIDIA Hopper (sm_90a): one warp runs
// `iters` dependent iterations of one variant's op chain and returns the
// int32 accumulator.
//
// Replaces tools/ubench_pallas.py::main.make (the `kern` closure it
// builds per variant).  It computes what that kernel computes — for a
// variant, a start value, an iteration count and the buffers, the
// accumulator after the loop — not how: each variant keeps the TPU
// variant's name and chains, on this card, the work that stands in the
// same place in csrc/mmp_scan.cu (a sublane/lane roll of a VMEM tile is a
// warp shuffle of a register tile, a VMEM or SMEM store a shared-memory
// store, a DMA with its semaphore a cp.async group with its wait).  The
// scan kernel's unit is a warp per lane, so one warp runs the loop and
// the accumulator is warp-uniform.  Three variants exist only here:
// bucket64, sa_window and text_read time the scan's three dependent
// global loads (k-mer bucket row, suffix-array window, candidate text).
//
// What bounds it on the card: latency, by construction — every iteration
// depends on the one before, so neither bytes nor operations per second
// limit it; the time per iteration is the length of the dependent chain.
// The design keeps each chain alive against the compiler: shared memory
// is accessed through volatile pointers, predicates and selects see the
// accumulator through an opaque move, global loads take their address
// from the accumulator, and every variant's result reaches the output.
//
// All int32 arithmetic wraps (done in uint32); ubench.py's plain version
// repeats it exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHbmRows = 1024 * 8 + 16;  // rows of 128 int32
constexpr int kRowInts = 128;
constexpr int kCopyRows = 16;            // one copy: 16 x 128 int32 = 8 KB

enum Variant {
  kEmpty = 0, kRoll16x4, kRoll1x4, kStore6, kAlignChain, kLcp, kWhen8True,
  kWhen8False, kWhen8Smem, kSelect8, kWhile0, kSmem16, kDma16, kDma16x4,
  kBucket64, kSaWindow, kTextRead, kNumVariants
};

struct Bufs {
  const int32_t* xs;     // (16,)
  const int32_t* tile;   // (16, 32)
  const int32_t* pair;   // (64,)
  const int32_t* al;     // (8, 64)
  const int32_t* hbm;    // (kHbmRows, 128)
  const int4* table;     // (2^table_bits, 16) int32 as 4 int4 per row
  const int32_t* sa;     // (2^sa_bits,), values: period starts in text
  const uint8_t* text;   // ((2^period_bits + 1) * 128,)
  const uint8_t* read;   // (128,), the first read_len bytes are live
  uint32_t table_mask, sa_n, period_mask;
  int read_len;
};

__device__ __forceinline__ uint32_t mix_kmer(uint32_t k0, uint32_t k1) {
  // the scan kernel's hash (csrc/mmp_scan.cu)
  uint32_t h = (k0 * 0x9E3779B1u) ^ (k1 * 0x85EBCA77u);
  h ^= h >> 15;
  h *= 0xC2B2AE3Du;
  h ^= h >> 13;
  return h;
}

// hides a value's history from the optimizer, so a chain through it is
// neither folded nor hoisted
__device__ __forceinline__ int32_t opaque(int32_t v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// one 8 KB copy, striped over the warp in 16-byte pieces
__device__ __forceinline__ void copy_rows(int32_t* dst, const int32_t* src,
                                          int t) {
  constexpr int kPieces = kCopyRows * kRowInts / 4;  // 16-byte pieces
  for (int p = t; p < kPieces; p += 32) cp_async16(dst + 4 * p, src + 4 * p);
  cp_async_commit();
}

// per-candidate body of the scan kernel: true-code text bytes from g
// against the read, until a mismatch, an N or the read end
__device__ __forceinline__ int walk(const Bufs& b, uint32_t g) {
  int j = 0;
  while (j < b.read_len) {
    const uint8_t a = b.read[j];
    if (a > 3 || a != __ldg(b.text + g + j)) break;
    ++j;
  }
  return j;
}

template <int V>
__global__ void __launch_bounds__(32)
ubench_kernel(int iters, int x0, Bufs b, int32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t dscr_s[4 * kCopyRows * kRowInts];
  __shared__ int32_t tile_s[16 * 32];
  __shared__ int32_t pair_s[64];
  __shared__ int32_t al_s[8 * 64];
  __shared__ int32_t xs_s[16];
  __shared__ int32_t scal_s[1];
  const int t = threadIdx.x;

  for (int i = t; i < 16 * 32; i += 32) tile_s[i] = b.tile[i];
  for (int i = t; i < 64; i += 32) pair_s[i] = b.pair[i];
  for (int i = t; i < 8 * 64; i += 32) al_s[i] = b.al[i];
  if (t < 16) xs_s[t] = b.xs[t];
  if (t == 0) scal_s[0] = 0;
  __syncwarp();

  volatile int32_t* tile = tile_s;
  volatile int32_t* pair = pair_s;
  volatile int32_t* al = al_s;
  volatile int32_t* xs = xs_s;
  volatile int32_t* scal = scal_s;
  volatile int32_t* dscr = dscr_s;

  int32_t acc = x0;
  for (int it = 0; it < iters; ++it) {
    const uint32_t ua = (uint32_t)acc;
    const int tt = (int)(ua & 7u);
    if constexpr (V == kEmpty) {
      acc = wadd(opaque(acc), 1);
    } else if constexpr (V == kRoll16x4) {
      int32_t r[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) r[j] = tile[j * 32 + t];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          r[j] = __shfl_sync(kFull, r[j], (t + tt) & 31);
      }
      uint32_t s = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) s += (uint32_t)r[j];
      acc = wadd(acc, __shfl_sync(kFull, (int32_t)s, 0));
    } else if constexpr (V == kRoll1x4) {
      int32_t r = pair[t];
#pragma unroll
      for (int k = 0; k < 4; ++k) r = __shfl_sync(kFull, r, (t + tt) & 31);
      acc = wadd(acc, __shfl_sync(kFull, r, 0));
    } else if constexpr (V == kStore6) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        pair[t] = tile[((j + tt) & 15) * 32 + t];
        pair[32 + t] = tile[((j + 1 + tt) & 15) * 32 + t];
      }
      __syncwarp();
      acc = wadd(acc, pair[0]);
      __syncwarp();
    } else if constexpr (V == kAlignChain) {
      const uint32_t lo = min(mix_kmer(ua, 0x9E3779B9u) & (b.sa_n - 1u),
                              b.sa_n - 32u);
      const uint32_t g = (uint32_t)__ldg(b.sa + lo + ((t + tt) & 31));
      acc = wadd(acc, __reduce_max_sync(kFull, walk(b, g)) + 1);
    } else if constexpr (V == kLcp) {
      const int start = (int)(ua & 63u);
      unsigned m = 64u;
#pragma unroll
      for (int h = 1; h >= 0; --h) {
        const int c = t + 32 * h;
        const int32_t a0 = al[c];
        bool neq = false;
#pragma unroll
        for (int r = 1; r < 8; ++r) neq |= (al[r * 64 + c] != a0);
        if (neq && c >= start) m = (unsigned)c;
      }
      acc = wadd(acc, (int32_t)__reduce_min_sync(kFull, m) + 1);
    } else if constexpr (V == kWhen8True) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (opaque(acc) >= j) pair[j] = j;
      acc = wadd(acc, 1);
    } else if constexpr (V == kWhen8False) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (opaque(acc) < -j - 1) pair[j] = j;
      acc = wadd(acc, 1);
    } else if constexpr (V == kWhen8Smem) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (opaque(acc) >= j) scal[0] = wadd(acc, j);
      acc = wadd(acc, 1);
    } else if constexpr (V == kSelect8) {
      int32_t v = acc;
#pragma unroll
      for (int j = 0; j < 8; ++j) v = (opaque(acc) >= j) ? wadd(v, j) : v;
      scal[0] = v;
      acc = wadd(acc, 1);
    } else if constexpr (V == kWhile0) {
      // zero trips while the accumulator is non-negative; the second
      // condition bounds the loop at one trip for a negative one
      int32_t r = acc;
      while (opaque(acc) < 0 && r == acc) r = wadd(r, 1);
      acc = wadd(r, 1);
    } else if constexpr (V == kSmem16) {
      int32_t v = acc;
#pragma unroll
      for (int k = 0; k < 16; ++k) v = wadd(v, xs[(uint32_t)v & 15u]);
      acc = wadd(v, 1);
    } else if constexpr (V == kDma16) {
      const uint32_t row = (ua & 1023u) * 8u;
      copy_rows(dscr_s, b.hbm + (size_t)row * kRowInts, t);
      cp_async_wait_all();
      __syncwarp();
      acc = wadd(acc, wadd(dscr[0], 1));
      __syncwarp();
    } else if constexpr (V == kDma16x4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t row = ((ua + 997u * (uint32_t)j) & 1023u) * 8u;
        copy_rows(dscr_s + j * kCopyRows * kRowInts,
                  b.hbm + (size_t)row * kRowInts, t);
      }
      cp_async_wait_all();
      __syncwarp();
      int32_t s = 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) s = wadd(s, dscr[j * kCopyRows * kRowInts]);
      acc = wadd(acc, s);
      __syncwarp();
    } else if constexpr (V == kBucket64) {
      // the scan's probe: every thread reads the same 64-byte row
      const uint32_t h = mix_kmer(ua, 0x85EBCA77u) & b.table_mask;
      const int4* p = b.table + (size_t)h * 4;
      const int4 v0 = __ldg(p), v1 = __ldg(p + 1);
      const int4 v2 = __ldg(p + 2), v3 = __ldg(p + 3);
      acc = wadd(acc, 1 + ((v0.x ^ v1.y ^ v2.z ^ v3.w) & 0xFFFF));
    } else if constexpr (V == kSaWindow) {
      // a C = 64 wide suffix-array window, two entries per thread
      const uint32_t lo = min(mix_kmer(ua, 0xC2B2AE3Du) & (b.sa_n - 1u),
                              b.sa_n - 64u);
      const uint32_t v = (uint32_t)__ldg(b.sa + lo + t) ^
                         (uint32_t)__ldg(b.sa + lo + 32 + t);
      acc = wadd(acc, 1 + (int32_t)(__reduce_add_sync(kFull, v) & 0xFFFFu));
    } else if constexpr (V == kTextRead) {
      // one candidate per thread, each at its own text position
      const uint32_t g =
          128u * (mix_kmer(ua + (uint32_t)t * 0x85EBCA77u, 0x9E3779B9u) &
                  b.period_mask);
      acc = wadd(acc, __reduce_max_sync(kFull, walk(b, g)) + 1);
    }
  }
  if (t == 0) out[0] = acc;
}

template <int V>
cudaError_t launch(int iters, int x0, const Bufs& b, int32_t* out,
                   cudaStream_t stream) {
  ubench_kernel<V><<<1, 32, 0, stream>>>(iters, x0, b, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sf_ubench_num_variants() { return kNumVariants; }

// Runs variant `variant` for `iters` iterations from `x0` on `stream` (a
// cudaStream_t) of `device` and writes the accumulator to out[0].  The
// table has 2^table_bits rows, the suffix array 2^sa_bits entries, the
// text 2^period_bits + 1 periods of 128 bytes.  Returns the cudaError_t
// of the launch (0 = success; cudaErrorInvalidValue for an unknown
// variant).
int sf_ubench(int variant, int iters, int x0, const void* xs,
              const void* tile, const void* pair, const void* al,
              const void* hbm, const void* table, int table_bits,
              const void* sa, int sa_bits, const void* text,
              int period_bits, const void* read, int read_len, void* out,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Bufs b;
  b.xs = (const int32_t*)xs;
  b.tile = (const int32_t*)tile;
  b.pair = (const int32_t*)pair;
  b.al = (const int32_t*)al;
  b.hbm = (const int32_t*)hbm;
  b.table = (const int4*)table;
  b.sa = (const int32_t*)sa;
  b.text = (const uint8_t*)text;
  b.read = (const uint8_t*)read;
  b.table_mask = (1u << table_bits) - 1u;
  b.sa_n = 1u << sa_bits;
  b.period_mask = (1u << period_bits) - 1u;
  b.read_len = read_len;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
#define SF_CASE(V) \
  case V:          \
    return (int)launch<V>(iters, x0, b, o, s);
    SF_CASE(kEmpty)
    SF_CASE(kRoll16x4)
    SF_CASE(kRoll1x4)
    SF_CASE(kStore6)
    SF_CASE(kAlignChain)
    SF_CASE(kLcp)
    SF_CASE(kWhen8True)
    SF_CASE(kWhen8False)
    SF_CASE(kWhen8Smem)
    SF_CASE(kSelect8)
    SF_CASE(kWhile0)
    SF_CASE(kSmem16)
    SF_CASE(kDma16)
    SF_CASE(kDma16x4)
    SF_CASE(kBucket64)
    SF_CASE(kSaWindow)
    SF_CASE(kTextRead)
#undef SF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
