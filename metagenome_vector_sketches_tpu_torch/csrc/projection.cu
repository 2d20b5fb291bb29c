// Kernel P: seeded +-1 random projection of hash sets (the sketch step).
//
// Replaces: metagenome_vector_sketches_tpu/ops/projection.py:107
// project_device_batch (an XLA program over (hi, lo) uint32 pairs emulating
// uint64, ops/splitmix.py:107 splitmix64_u32, with SWAR lane counters and a
// zero-padding correction). Math: for each hash h and 64-lane block b,
// x = splitmix64(h + 64 b); lane n of the block gets 1 - 2*bit_n(x), i.e.
// vec[64 b + n] = count - 2 * sum_h bit_n(x) (reference
// src/random_projection.cpp:9-26).
//
// What bounds it on Hopper: integer ALU work, ~20 64-bit operations per
// (hash, block) for splitmix64 plus 64 ballots per 32 hashes; the hash
// bytes read are tiny (each set is read once per block and stays in L1/L2).
//
// Design: one warp per (set, 64-lane block). The ragged sets arrive as CSR
// (flat hashes + offsets), so there is no padding and no pad correction.
// Each lane takes the hashes strided by 32 and computes splitmix64 in
// native uint64_t (the TPU's u32-pair emulation is gone). For each bit n,
// __popc(__ballot_sync(bit n of the 32 lanes' x)) is the bit count over
// those 32 hashes; lane n mod 32 accumulates it (the low word's bits, then
// the high word's), so every lane ends holding two of the block's 64 lane
// sums and writes them without any shared-memory reduction.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
project_kernel(const uint64_t* __restrict__ hashes,
               const int64_t* __restrict__ offsets, int n_sets, int n_blocks,
               int d, int32_t* __restrict__ out) {
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n_sets * n_blocks) return;  // whole warp leaves
  const int set = (int)(warp / n_blocks);
  const int b = (int)(warp % n_blocks);
  const int64_t s = offsets[set], e = offsets[set + 1];
  const uint64_t block_offset = 64ull * (uint64_t)b;
  unsigned lo_sum = 0, hi_sum = 0;   // bit counts of lanes `lane`, `lane+32`
  for (int64_t base = s; base < e; base += 32) {  // warp-uniform loop
    const int64_t i = base + lane;
    const uint64_t x = i < e ? splitmix64(hashes[i] + block_offset) : 0ull;
    const unsigned xlo = (unsigned)x, xhi = (unsigned)(x >> 32);
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const unsigned mlo = __ballot_sync(kFullMask, (xlo >> n) & 1u);
      const unsigned mhi = __ballot_sync(kFullMask, (xhi >> n) & 1u);
      if (lane == n) {
        lo_sum += __popc(mlo);
        hi_sum += __popc(mhi);
      }
    }
  }
  const int count = (int)(e - s);
  int32_t* row = out + (long long)set * d;
  const int col = b * 64 + lane;
  if (col < d) row[col] = count - 2 * (int)lo_sum;
  if (col + 32 < d) row[col + 32] = count - 2 * (int)hi_sum;
}

}  // namespace

// hashes: (H,) uint64 (int64 bits); offsets: (n_sets + 1,) int64;
// out: (n_sets, d) int32.
MVS_EXPORT int mvs_project(const void* hashes, const void* offsets,
                           int n_sets, int d, void* out, void* stream) {
  const int n_blocks = (d + 63) / 64;
  const long long warps = (long long)n_sets * n_blocks;
  if (warps > 0) {
    const long long grid = (warps * 32 + kThreads - 1) / kThreads;
    project_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)hashes, (const int64_t*)offsets, n_sets, n_blocks, d,
        (int32_t*)out);
  }
  return mvs_launch_status();
}
