// Kernels C and M: the light co-occurrence counts and the retention
// epilogue of the exact MinHash shard (ops/minhash.py).
//
// They replace no TPU kernel. The JAX package computes the whole N x N
// intersection matrix as dense incidence Grams over the hash universe
// (metagenome_vector_sketches_tpu/ops/minhash.py:47 _chunk_gram, N^2 U
// work whatever the sparsity) and tests it on the host (minhash_triples).
// The port splits the hashes by how many sets hold them: the heavy ones
// (kernel G, sweep.cu mvs_gram_rows) and the light
// ones, whose postings kernel C counts here, only for the shard's rows.
//
// Kernel C (entry mvs_cooc): for each light posting (the ascending set ids
// of one hash), each member i in the shard's rows [b, e) and each member j:
// c[i - b, j] += 1. One warp a posting, the grid striding over postings:
// the lanes read the posting (at most a few hundred ids) and count the
// members below b and below e with ballots, which gives the contiguous run
// of in-range members; then the (run x posting) increments are spread over
// the lanes. What bounds it on the H100: the increments, scattered 4-byte
// atomics (red.global.add) over an accumulator larger than the 50 MB L2,
// each a read and a write of a 32-byte sector in device memory; the
// postings are read once, coalesced. A warp adds its increments to one
// 64-bit counter once.
//
// Kernel M (entry mvs_minhash_keep): every (row, column) of the shard's
// accumulator once, a warp 32 neighbouring columns of a row at a step
// (coalesced 4-byte loads): the intersection (|A| on the diagonal, whose
// hashes held by one set alone never reach the accumulator), the
// reference's test inter > 0.05 (|A| + |B|) in float64 with explicitly
// rounded intrinsics (the order numpy's minhash_triples writes), and the
// kept pairs compacted with one ballot and one atomic a warp into (row |
// column << 32, inter) int64 pairs; the kept count is exact past the
// buffer's capacity, so the wrapper reruns at the exact size. Bound: the
// accumulator's bytes, read once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    cooc_kernel(const int32_t* __restrict__ sets,
                const long long* __restrict__ off, long long n_post, int b,
                int e, int32_t* __restrict__ c, long long ldc,
                unsigned long long* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  unsigned long long mine = 0;
  for (long long p = warp; p < n_post; p += stride) {
    const long long s = off[p];
    const int len = (int)(off[p + 1] - s);
    int lo = 0, hi = 0;
    for (int k0 = 0; k0 < len; k0 += 32) {
      const int k = k0 + lane;
      const int m = k < len ? __ldg(&sets[s + k]) : INT32_MAX;
      lo += __popc(__ballot_sync(kFullMask, m < b));
      hi += __popc(__ballot_sync(kFullMask, m < e));
    }
    const int run = hi - lo;
    if (run == 0) continue;
    const int work = run * len;
    for (int w = lane; w < work; w += 32) {
      const int i = w / len, j = w - i * len;
      const long long row = __ldg(&sets[s + lo + i]) - b;
      atomicAdd(&c[row * ldc + __ldg(&sets[s + j])], 1);
    }
    if (lane == 0) mine += (unsigned long long)work;
  }
  if (lane == 0 && mine) atomicAdd(count, mine);
}

__global__ void __launch_bounds__(kThreads)
    keep_kernel(const int32_t* __restrict__ c, long long ldc, int rows, int n,
                int b, const long long* __restrict__ sizes,
                longlong2* __restrict__ out, long long cap,
                unsigned long long* __restrict__ kept) {
  const int lane = threadIdx.x & 31;
  // a warp step is 32 neighbouring columns of one row: every lane of a warp
  // walks the same steps, so the ballots see the whole warp
  const long long spans = (n + 31) / 32;
  const long long steps = (long long)rows * spans;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long t = warp; t < steps; t += stride) {
    const long long row = t / spans;
    const long long col = (t - row * spans) * 32 + lane;
    const long long gr = b + row;
    bool keep = false;
    long long inter = 0;
    if (col < n) {
      inter = col == gr ? sizes[gr] : (long long)c[row * ldc + col];
      const double thr = __dmul_rn(0.05, (double)(sizes[gr] + sizes[col]));
      keep = (double)inter > thr;
    }
    const unsigned bal = __ballot_sync(kFullMask, keep);
    if (!bal) continue;
    unsigned long long first = 0;
    if (lane == 0) first = atomicAdd(kept, (unsigned long long)__popc(bal));
    first = __shfl_sync(kFullMask, first, 0);
    if (keep) {
      const unsigned long long at =
          first + __popc(bal & ((1u << lane) - 1u));
      if (at < (unsigned long long)cap)
        out[at] = make_longlong2(gr | (col << 32), inter);
    }
  }
}

int grid_for(const void* fn, long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(work < full ? (work > 0 ? work : 1) : full);
}

}  // namespace

// Kernel C. sets: the light postings' members (int32, ascending within a
// posting), off: (n_post + 1) int64 offsets; c: (>= e - b, ldc) int32, the
// shard's accumulator; count: one uint64, += the increments made.
MVS_EXPORT int mvs_cooc(const void* sets, const void* off, long long n_post,
                        int b, int e, void* c, long long ldc, void* count,
                        void* stream) {
  if (n_post < 0 || b < 0 || e < b || ldc <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_post == 0 || e == b) return 0;
  const int grid = grid_for((const void*)cooc_kernel,
                            (n_post + kWarps - 1) / kWarps);
  cooc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sets, (const long long*)off, n_post, b, e, (int32_t*)c,
      ldc, (unsigned long long*)count);
  return mvs_launch_status();
}

// Kernel M. c: (>= rows, ldc) int32, the shard's accumulator (rows b ..
// b + rows - 1 against n sets); sizes: (n) int64 set sizes; out: (cap, 2)
// int64 kept pairs; kept: one zeroed uint64, the kept count (exact past
// cap).
MVS_EXPORT int mvs_minhash_keep(const void* c, long long ldc, int rows, int n,
                                int b, const void* sizes, void* out,
                                long long cap, void* kept, void* stream) {
  if (rows < 0 || n < 0 || b < 0 || ldc < n || cap < 0 || b + rows > n)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  const long long work = ((long long)rows * ((n + 31) / 32) + kWarps - 1) /
                         kWarps;
  const int grid = grid_for((const void*)keep_kernel, work);
  keep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)c, ldc, rows, n, b, (const long long*)sizes,
      (longlong2*)out, cap, (unsigned long long*)kept);
  return mvs_launch_status();
}
