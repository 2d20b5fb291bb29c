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
// What bounds it on Hopper: integer instructions. The work no design
// avoids is splitmix64 per (hash, block): 22 SASS instructions (below),
// against 8 B read per hash and 4 d B written per set.
//
// Design:
// - Work items, not sets. The wrapper cuts each set into items of at most
//   `chunk` hashes (ops/projection.py chunk_items: set s owns items
//   item_off[s] .. item_off[s + 1] - 1; an empty set has one empty item).
//   One warp takes one item and finds its set by a binary search over
//   item_off, so a set of 80,000 hashes is spread over many SMs instead of
//   holding one. A set of one item stores its row; the items of a larger set
//   add theirs with integer atomics (order-free: bit-equal) into a row that
//   a small kernel launched just before zeroes, so that only the rows of
//   such sets are written twice.
// - Lanes <-> (block, slice). A pass covers nbp <= 32 blocks: lane l takes
//   block l % nbp and hash slice l / nbp (32 / nbp slices of whole 16-hash
//   groups), so at d = 2048 every lane owns one block and reads every hash,
//   at d = 256 eight lanes share a block, and d > 2048 takes several passes.
//   splitmix64 runs in native uint64_t; the constant 64 b + golden is added
//   once per hash.
// - Hashes are staged per warp in shared memory, 256 at a time (coalesced
//   loads), group g at word 18 g so that 8 slices read 8 different bank
//   groups, and read back as 16-byte broadcasts.
// - Counting without ballots: each lane keeps bit-sliced counters of its
//   block's 64 lanes as two 32-bit halves. Harley-Seal carry-save adders
//   (sum = a^b^c, carry = maj(a,b,c): one LOP3 each) reduce every group of
//   16 words into the ones/twos/fours/eights slices and one word of
//   sixteens, which ripples into an 8-level counter. Capacity:
//   16 (2^8 - 1) + 15 = 4095 words per lane, so an item holds at most
//   kMaxChunk hashes and nothing is flushed inside an item.
// - Counts out: a 32 x 32 bit transpose of each half's 12 slices (bit n of
//   slice k -> bit k of the count of lane n), written to shared memory and
//   summed over slices, then the warp writes the row as 16-byte stores (or
//   integer atomics for a shared row).
//
// SASS (cuobjdump -sass of this file for sm_90a, nvcc 12.8): one group of
// 16 hashes is 458 instructions per lane, 28.6 per (hash, block).
// splitmix64 with its 64-bit add is 22 of them: the add as IADD3 +
// IMAD.X, each 64-bit multiply as IMAD.WIDE.U32 + 2 IMAD + IMAD.IADD, each
// 64-bit xor-shift as 2 SHF + 2 LOP3. The carry-save count and the staged
// loads are the other 6.6 (LOP3s and one LDS.128 per 2 hashes). Only the
// IMADs (146 of the 458) go to the FMA pipe; the rest share the integer
// ALU pipe, 16 lanes per SM sub-partition and clock, which is what holds
// the kernel: 76 registers, no spills, 36,864 B of shared memory per CTA.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                // words per Harley-Seal group
constexpr int kLevels = 8;                // levels of the sixteens counter
constexpr int kMaxChunk = kGroup * ((1 << kLevels) - 1) + kGroup - 1;
constexpr int kStage = 256;               // hashes staged per step
constexpr int kGroupStride = kGroup + 2;  // staged words per group (skew)
constexpr int kRow = 36;                  // shared row of 32 counts, padded
constexpr int kWarpBytes = 32 * kRow * 4;
static_assert(kStage / kGroup * kGroupStride * 8 <= kWarpBytes,
              "the hash stage must fit the warp's count rows");

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  // splitmix64 after its "+= golden"
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// carry-save adder over 32 bit positions: a + b + c = lo + 2 hi
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a,
                                    uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// bit-sliced counts of 32 positions: ones + 2 twos + 4 fours + 8 eights +
// 16 * (sum_k 2^k top[k])
struct Counter {
  uint32_t ones, twos, fours, eights, top[kLevels];
};

// Harley-Seal: add 16 words to the counter
__device__ __forceinline__ void add16(Counter& c, const uint32_t (&w)[16]) {
  uint32_t twos_a, twos_b, fours_a, fours_b, eights_a, eights_b, sixteens;
  csa(twos_a, c.ones, c.ones, w[0], w[1]);
  csa(twos_b, c.ones, c.ones, w[2], w[3]);
  csa(fours_a, c.twos, c.twos, twos_a, twos_b);
  csa(twos_a, c.ones, c.ones, w[4], w[5]);
  csa(twos_b, c.ones, c.ones, w[6], w[7]);
  csa(fours_b, c.twos, c.twos, twos_a, twos_b);
  csa(eights_a, c.fours, c.fours, fours_a, fours_b);
  csa(twos_a, c.ones, c.ones, w[8], w[9]);
  csa(twos_b, c.ones, c.ones, w[10], w[11]);
  csa(fours_a, c.twos, c.twos, twos_a, twos_b);
  csa(twos_a, c.ones, c.ones, w[12], w[13]);
  csa(twos_b, c.ones, c.ones, w[14], w[15]);
  csa(fours_b, c.twos, c.twos, twos_a, twos_b);
  csa(eights_b, c.fours, c.fours, fours_a, fours_b);
  csa(sixteens, c.eights, c.eights, eights_a, eights_b);
  uint32_t carry = sixteens;
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const uint32_t t = c.top[k] & carry;
    c.top[k] ^= carry;
    carry = t;
  }
}

// One group of 16 staged hashes into both halves' counters; kTail zeroes
// the words from `valid` on (the last group of an item).
template <bool kTail>
__device__ __forceinline__ void count_group(Counter (&c)[2],
                                            const uint64_t* g, int valid,
                                            uint64_t boff) {
  uint32_t lo[kGroup], hi[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; i += 2) {
    const ulonglong2 h = *reinterpret_cast<const ulonglong2*>(g + i);
    uint64_t x0 = mix(h.x + boff), x1 = mix(h.y + boff);
    if (kTail) {
      x0 = i < valid ? x0 : 0ull;
      x1 = i + 1 < valid ? x1 : 0ull;
    }
    lo[i] = (uint32_t)x0;
    hi[i] = (uint32_t)(x0 >> 32);
    lo[i + 1] = (uint32_t)x1;
    hi[i + 1] = (uint32_t)(x1 >> 32);
  }
  add16(c[0], lo);
  add16(c[1], hi);
}

// 32 x 32 bit transpose: afterwards bit k of a[n] is bit n of the old a[k]
template <int J>
__device__ __forceinline__ void transpose_step(uint32_t (&a)[32],
                                               uint32_t m) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int k = (i / J) * 2 * J + i % J;  // the 16 rows with bit J clear
    const uint32_t t = ((a[k] >> J) ^ a[k + J]) & m;
    a[k + J] ^= t;
    a[k] ^= t << J;
  }
}

__device__ __forceinline__ void transpose32(uint32_t (&a)[32]) {
  transpose_step<16>(a, 0x0000FFFFu);
  transpose_step<8>(a, 0x00FF00FFu);
  transpose_step<4>(a, 0x0F0F0F0Fu);
  transpose_step<2>(a, 0x33333333u);
  transpose_step<1>(a, 0x55555555u);
}

// One warp per set: zero the output row of a set of several items (their
// items add into it); leave the other rows alone.
__global__ void __launch_bounds__(kThreads)
project_zero_split_rows(const int64_t* __restrict__ item_off, int n_sets,
                        int d, int32_t* __restrict__ out) {
  const long long set = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (set >= n_sets || item_off[set + 1] - item_off[set] <= 1) return;
  int32_t* row = out + set * d;
  for (int c = threadIdx.x & 31; c < d; c += 32) row[c] = 0;
}

__global__ void __launch_bounds__(kThreads)
project_kernel(const uint64_t* __restrict__ hashes,
               const int64_t* __restrict__ offsets,
               const int64_t* __restrict__ item_off, int n_sets, int chunk,
               int n_blocks, int d, int32_t* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem[kWarps][kWarpBytes];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWarps + wib;
  if (item >= item_off[n_sets]) return;  // whole warp leaves
  int set = 0, top = n_sets - 1;         // the last set with item_off <= item
  while (set < top) {
    const int mid = (set + top + 1) >> 1;
    if (item_off[mid] <= item) set = mid;
    else top = mid - 1;
  }
  const long long k = item - item_off[set];
  const bool shared_row = item_off[set + 1] - item_off[set] > 1;
  const int64_t start = offsets[set] + k * chunk;
  const int64_t left = offsets[set + 1] - start;
  const int n = left < chunk ? (int)left : chunk;
  uint64_t* stage = reinterpret_cast<uint64_t*>(smem[wib]);
  int32_t* rows = reinterpret_cast<int32_t*>(smem[wib]);
  int32_t* orow = out + (long long)set * d;

  for (int b0 = 0; b0 < n_blocks; b0 += 32) {
    const int nbp = min(32, n_blocks - b0);
    const int slices = 32 / nbp;
    const int sl = lane / nbp;
    const bool active = sl < slices;
    const uint64_t boff = 64ull * (uint64_t)(b0 + lane % nbp)
                          + 0x9E3779B97F4A7C15ull;
    Counter c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h].ones = c[h].twos = c[h].fours = c[h].eights = 0u;
#pragma unroll
      for (int t = 0; t < kLevels; ++t) c[h].top[t] = 0u;
    }
    for (int base = 0; base < n; base += kStage) {
      const int m = min(kStage, n - base);
      __syncwarp();  // every lane is done with the previous piece
      for (int j = lane; j < m; j += 32)
        stage[j + 2 * (j / kGroup)] = __ldg(
            reinterpret_cast<const unsigned long long*>(hashes) + start + base
            + j);
      __syncwarp();
      const int groups = (m + kGroup - 1) / kGroup;
      const int g0 = base / kGroup;
      if (active) {
        for (int gi = (sl - g0 % slices + slices) % slices; gi < groups;
             gi += slices) {
          const uint64_t* g = stage + kGroupStride * gi;
          const int valid = m - gi * kGroup;
          if (valid >= kGroup) count_group<false>(c, g, kGroup, boff);
          else count_group<true>(c, g, valid, boff);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t a[32];
      a[0] = c[h].ones;
      a[1] = c[h].twos;
      a[2] = c[h].fours;
      a[3] = c[h].eights;
#pragma unroll
      for (int t = 0; t < kLevels; ++t) a[4 + t] = c[h].top[t];
#pragma unroll
      for (int t = 4 + kLevels; t < 32; ++t) a[t] = 0u;
      transpose32(a);  // a[i] = this lane's count of block lane 32 h + i
      __syncwarp();    // the stage / the previous half's rows are read
      if (active) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          *reinterpret_cast<int4*>(rows + lane * kRow + 4 * q) =
              make_int4((int)a[4 * q], (int)a[4 * q + 1], (int)a[4 * q + 2],
                        (int)a[4 * q + 3]);
      }
      __syncwarp();
      for (int idx = lane; idx < nbp * 8; idx += 32) {
        const int blk = idx >> 3, q = idx & 7;
        int4 v = *reinterpret_cast<const int4*>(rows + blk * kRow + 4 * q);
        for (int s = 1; s < slices; ++s) {
          const int4 w = *reinterpret_cast<const int4*>(
              rows + (s * nbp + blk) * kRow + 4 * q);
          v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        v = make_int4(n - 2 * v.x, n - 2 * v.y, n - 2 * v.z, n - 2 * v.w);
        const int col = 64 * (b0 + blk) + 32 * h + 4 * q;
        const int e[4] = {v.x, v.y, v.z, v.w};
        if (shared_row) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (col + t < d) atomicAdd(orow + col + t, e[t]);
        } else if ((d & 3) == 0) {
          if (col < d) *reinterpret_cast<int4*>(orow + col) = v;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (col + t < d) orow[col + t] = e[t];
        }
      }
    }
  }
}

}  // namespace

// hashes: (H,) uint64 (int64 bits); offsets: (n_sets + 1,) int64;
// item_off: (n_sets + 1,) int64 work-item offsets of the sets (items of at
// most `chunk` hashes, ops/projection.py chunk_items); max_items: a bound on
// item_off[n_sets] (the grid); out: (n_sets, d) int32, every element written.
MVS_EXPORT int mvs_project(const void* hashes, const void* offsets,
                           const void* item_off, int n_sets,
                           long long max_items, int chunk, int d, void* out,
                           void* stream) {
  if (n_sets < 1 || d < 1 || chunk < 1 || chunk > kMaxChunk
      || max_items < n_sets)
    return (int)cudaErrorInvalidValue;
  const long long grid = (max_items + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  project_zero_split_rows<<<(unsigned)((n_sets + kWarps - 1) / kWarps),
                            kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)item_off, n_sets, d, (int32_t*)out);
  project_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)hashes, (const int64_t*)offsets,
      (const int64_t*)item_off, n_sets, chunk, (d + 63) / 64, d,
      (int32_t*)out);
  return mvs_launch_status();
}
