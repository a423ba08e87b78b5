// The collapsed EM's iterations for NVIDIA Hopper (sm_90a): one persistent
// cooperative launch a solve.
//
// Replaces no Pallas kernel: the JAX package's step
// (sailfish_tpu/infer/em.py `_em_step` inside `_optimize_jit`'s while loop)
// is XLA.  The port ran the step as some 20 small torch launches and read
// the convergence test on the host once an iteration, so the card sat idle
// for most of a solve.  This kernel runs every iteration of a solve, the
// convergence test and the stop rule included; the host waits once.
//
// The function, per iteration (infer/em.py `_em_step` and run_em's loop
// are its plain version):
//   class phase, class-major over the CSR membership:
//     denom[c] = sum over c's members j of alpha[t_j] * w_j;
//     scale[c] = count[c] / denom[c] where c has more than one member and
//     denom[c] > min_w, else 0 (a singleton class's count is in `sing`);
//   transcript phase, transcript-major (the members sorted by transcript,
//   stably):
//     out[t] = sum over t's members j of (alpha[t] * w_j) * scale[c_j],
//     plus sing[t];
//     t fails the convergence test when out[t] > cutoff and not
//     |alpha[t] - out[t]| / out[t] <= tol;
//   stop rule: iterate while it < min_iter or (it < max_iter and not
//   converged), where an iteration from it >= min_iter on sets
//   `converged` to "no transcript failed".
//
// What bounds it on the card: bytes, and the latency of two grid-wide
// barriers an iteration.  An iteration needs the membership once in each
// order (a transcript, a class and a weight a member), the counts and the
// offsets, and reads and writes the alphas: about 16 B a member, 12 B a
// class and 24 B a transcript (about 10 MB for 325,000 members, 78,000
// classes and 150,000 transcripts: 3 us at the card's memory rate).  Such
// a problem fits in the 50 MB L2, so after the first iteration the bytes
// come from there.  The tables are infer/em.py `kernel_tables`: the
// classes renumbered by their first member, so that the gathers of both
// phases share sectors, and no chunk for a transcript in no class (the
// host zeroes its alpha in both buffers).  The design:
//   - one launch for the whole solve, as many blocks as the chunks need and
//     the SMs hold at once (a cooperative launch, so every block is
//     resident and `grid.sync()` is safe); the loop, the convergence test
//     and the stop rule run on the card, and the host reads the result
//     block once;
//   - both phases gather over CSR rows and scatter nothing but a long
//     row's partial sums: no float atomics, so every sum has a fixed order
//     and a solve gives the same alphas on every run;
//   - a phase ends at a grid barrier, so it lasts as long as its slowest
//     row: rows are cut into chunks of at most kChunk entries, a thread a
//     chunk, each chunk's loads in flight together.  A row of one chunk is
//     summed in its entries' order, the order of the plain version's
//     sequential scatter on the CPU; a longer row's chunks count
//     themselves in, and the last to arrive adds their sums in chunk
//     order.  A thread's first chunk in each phase (its record and its
//     row's count) is read once a solve and kept in registers; a problem
//     with more chunks than the card holds threads reads the rest as it
//     goes;
//   - products and sums use the _rn intrinsics, so no multiply-add is
//     fused and each term rounds as in the plain version;
//   - what the launch itself writes (the alphas, the scales, the partial
//     sums, the flags) is read with ld.global.cg, from L2, never through
//     the read-only path;
//   - the convergence test writes one of two flags, used in turn: each
//     iteration clears the flag of the next after the first barrier, when
//     every block has read the previous iteration's.
//
// A template over the value type: float64 (the default) and float32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double absv(double a) { return fabs(a); }
__device__ __forceinline__ float absv(float a) { return fabsf(a); }

template <typename T>
struct EmArgs {
  const int4* crec;   // n_cchunks chunk records of the classes' rows
  const int4* trec;   // n_tchunks chunk records of the transcripts' rows
  const int* members; // the members' transcripts, class-major
  const T* w;         // the members' weights, class-major
  const T* counts;    // n_classes
  const int* tcls;    // the members' classes, transcript-major
  const T* tw;        // the members' weights, transcript-major
  const T* sing;      // n_txps: the count of each transcript's singleton
  T* alpha;           // n_txps: the start, then every even iteration's out
  T* next;            // n_txps: every odd iteration's out
  T* scale;           // n_classes, scratch
  T* part;            // a partial sum a chunk, scratch
  int* arrived;       // a counter a row, zero on entry and on exit
  int* result;        // iterations, converged, flag 0, flag 1
  int n_cchunks;
  int n_tchunks;
  T min_w;
  T cutoff;
  T tol;
  int min_iter;
  int max_iter;
};

// One chunk of a CSR's rows, from its record (row, first entry, entries |
// chunks of the row << 8, the row's first chunk), or row -1 for padding:
// at most kChunk entries a chunk.  `c` is the row's own constant (a
// class's count, a transcript's singleton count).
template <typename T>
struct Chunk {
  int k, row, first, len, nch, k0;
  T c;
};

template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const int4* rec, int n, int k,
                                               const T* row_value) {
  Chunk<T> ch{k, -1, 0, 0, 1, 0, T(0)};
  if (k < n) {
    const int4 c = __ldg(rec + k);
    ch.row = c.x;
    ch.first = c.y;
    ch.len = c.z & 0xff;
    ch.nch = c.z >> 8;
    ch.k0 = c.w;
    if (ch.row >= 0) ch.c = __ldg(row_value + ch.row);
  }
  return ch;
}

// A thread's part of a phase for one chunk: the sum of term(j, x), x =
// ctx(row), over the chunk's entries in their order, its kChunk loads in
// flight together.  A row of one chunk is then done; in a longer row each
// chunk stores its sum and counts itself in, and the last to arrive adds
// the row's sums in chunk order (so the sum is the same on every run) and
// resets the row's counter.  Every lane of the warp calls done(chunk,
// finished, sum, x), so that `done` may vote.
template <typename T, typename Ctx, typename Term, typename Done>
__device__ __forceinline__ void chunk_pass(const Chunk<T>& ch, T* part,
                                           int* arrived, Ctx ctx, Term term,
                                           Done done) {
  bool fin = false;
  T sum = T(0), x = T(0);
  if (ch.row >= 0) {
    x = ctx(ch.row);
    T v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      v[u] = u < ch.len ? term(ch.first + u, x) : T(0);
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (u < ch.len) sum = add(sum, v[u]);
    if (ch.nch == 1) {
      fin = true;
    } else {
      part[ch.k] = sum;
      __threadfence();
      if (atomicAdd(arrived + ch.row, 1) == ch.nch - 1) {
        __threadfence();
        sum = T(0);
#pragma unroll 4
        for (int i = 0; i < ch.nch; ++i)
          sum = add(sum, __ldcg(part + ch.k0 + i));
        arrived[ch.row] = 0;
        fin = true;
      }
    }
  }
  done(ch, fin, sum, x);
}

// One phase: the thread's first chunk (k = its index in the grid) was
// loaded once for the whole solve; any further ones (a grid too small
// for the chunks) are loaded each time.  The loop's bound is the same
// for every lane of a warp.
template <typename T, typename Ctx, typename Term, typename Done>
__device__ __forceinline__ void phase(const Chunk<T>& mine, const int4* rec,
                                      int n, const T* row_value, T* part,
                                      int* arrived, Ctx ctx, Term term,
                                      Done done) {
  chunk_pass(mine, part, arrived, ctx, term, done);
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * blockDim.x;
  for (int k = mine.k + stride; k - lane < n; k += stride)
    chunk_pass(load_chunk(rec, n, k, row_value), part, arrived, ctx, term,
               done);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) em_solve_kernel(EmArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const bool leader = k == 0;
  const Chunk<T> cls = load_chunk(a.crec, a.n_cchunks, k, a.counts);
  const Chunk<T> txp = load_chunk(a.trec, a.n_tchunks, k, a.sing);
  int* flags = a.result + 2;
  int it = 0;
  bool converged = false;
  while (it < a.min_iter || (it < a.max_iter && !converged)) {
    const T* cur = (it & 1) ? a.next : a.alpha;
    T* out = (it & 1) ? a.alpha : a.next;

    phase<T>(
        cls, a.crec, a.n_cchunks, a.counts, a.part, a.arrived,
        [](int) { return T(0); },
        [=](int j, T) {
          return mul(__ldcg(cur + __ldg(a.members + j)), __ldg(a.w + j));
        },
        [=](const Chunk<T>& ch, bool fin, T denom, T) {
          if (fin)
            a.scale[ch.row] =
                ((ch.nch > 1 || ch.len > 1) && denom > a.min_w) ? ch.c / denom
                                                                : T(0);
        });
    grid.sync();

    if (leader) flags[(it + 1) & 1] = 0;
    int* flag = flags + (it & 1);
    phase<T>(
        txp, a.trec, a.n_tchunks, a.sing, a.part, a.arrived,
        [=](int r) { return __ldcg(cur + r); },
        [=](int j, T x) {
          return mul(mul(x, __ldg(a.tw + j)),
                     __ldcg(a.scale + __ldg(a.tcls + j)));
        },
        [=](const Chunk<T>& ch, bool fin, T sum, T x) {
          bool fail = false;
          if (fin) {
            const T o = add(sum, ch.c);
            out[ch.row] = o;
            fail = o > a.cutoff && !(absv(x - o) / o <= a.tol);
          }
          if (__any_sync(kFull, fail) && (threadIdx.x & 31) == 0) *flag = 1;
        });
    grid.sync();

    ++it;
    if (it >= a.min_iter) converged = __ldcg(flag) == 0;
  }
  if (leader) {
    a.result[0] = it;
    a.result[1] = converged ? 1 : 0;
  }
}

template <typename T>
int launch(EmArgs<T> a, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, em_solve_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  // a thread a chunk of the longer phase, and no more blocks than the
  // card holds at once
  const long long n =
      a.n_tchunks > a.n_cchunks ? a.n_tchunks : a.n_cchunks;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  if (blocks < 1) blocks = 1;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)em_solve_kernel<T>,
                                    dim3((unsigned)blocks), dim3(kThreads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int solve(const void* crec, int n_cchunks, const void* members,
          const void* w, const void* counts, const void* trec, int n_tchunks,
          const void* tcls, const void* tw, const void* sing, void* alpha,
          void* next, void* scale, void* part, void* arrived, void* result,
          double min_w, double cutoff, double tol, int min_iter,
          int max_iter, int device, void* stream) {
  EmArgs<T> a;
  a.crec = (const int4*)crec;
  a.trec = (const int4*)trec;
  a.members = (const int*)members;
  a.w = (const T*)w;
  a.counts = (const T*)counts;
  a.tcls = (const int*)tcls;
  a.tw = (const T*)tw;
  a.sing = (const T*)sing;
  a.alpha = (T*)alpha;
  a.next = (T*)next;
  a.scale = (T*)scale;
  a.part = (T*)part;
  a.arrived = (int*)arrived;
  a.result = (int*)result;
  a.n_cchunks = n_cchunks;
  a.n_tchunks = n_tchunks;
  a.min_w = (T)min_w;
  a.cutoff = (T)cutoff;
  a.tol = (T)tol;
  a.min_iter = min_iter;
  a.max_iter = max_iter;
  return launch<T>(a, device, stream);
}

}  // namespace

extern "C" {

// Runs a whole EM solve on `stream` (a cudaStream_t) of `device`: float64
// values where `f64` is 1, float32 where 0.  `crec` holds n_cchunks
// chunk records (int4, see `Chunk`) over the members in class order
// (`members` int32, `w`), `trec` n_tchunks over them in transcript order
// (`tcls` int32, `tw`).  `alpha` holds the start and `next` as many
// values more: after the solve the latest alphas are in `alpha` when the
// iteration count is even and in `next` when odd, the previous
// iteration's in the other.  `scale` (a value a class) and `part` (a
// value a chunk of the longer table) are scratch; `arrived` holds an
// int32 for each class and each transcript (as many as the more of the
// two), zero.  `result` is 4 int32, zero on entry: the kernel writes the
// iteration count to [0] and converged (0 or 1) to [1]; [2] and [3] are
// its flags.  `chunk` is the most entries a record's chunk holds, which
// must be the kernel's kChunk.  Returns the cudaError_t of the launch (0
// = success).
int sf_em_solve(int f64, int chunk, const void* crec, int n_cchunks,
                const void* members, const void* w, const void* counts,
                const void* trec, int n_tchunks, const void* tcls,
                const void* tw, const void* sing, void* alpha, void* next,
                void* scale, void* part, void* arrived, void* result,
                double min_w, double cutoff, double tol, int min_iter,
                int max_iter, int device, void* stream) {
  if (chunk != kChunk || n_cchunks < 1 || n_tchunks < 1)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto fn) {
    return fn(crec, n_cchunks, members, w, counts, trec, n_tchunks, tcls,
              tw, sing, alpha, next, scale, part, arrived, result, min_w,
              cutoff, tol, min_iter, max_iter, device, stream);
  };
  return f64 ? go(solve<double>) : go(solve<float>);
}

}  // extern "C"
