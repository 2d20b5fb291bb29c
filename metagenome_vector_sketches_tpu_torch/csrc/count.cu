// Kernels COUNT and APPEND: the retention sweep over a list of tiles on
// Hopper, one persistent kernel (retention_kernel<kAppend, kPow2>) with two
// epilogues (entries mvs_count and mvs_append).
//
// COUNT replaces: metagenome_vector_sketches_tpu/ops/pallas_pairwise.py:55
// pallas_sweep_counts (the repo's one Pallas kernel, body _make_kernel at
// :27), on its path, the two-phase engine's counts sweep (JAX
// matrix/compute.py:830-846): each tile's survivors, summed into
// counts[tile].
// APPEND replaces: the sweep + survivor compaction of the XLA program
// metagenome_vector_sketches_tpu/ops/pairwise.py:635 sweep_extract_fused_ij
// (the fused engine's sweep; the two-phase engine's hot-tile extraction):
// the same per-tile counts, and every survivor's operand-local (row,
// column) int32 pair written into a flat buffer rc of capacity `cap`.
//
// Math, per (row, column) pair of every tile in a list: P int8 x int8 ->
// int32 plane products (exact), combined in float32 in plane order,
//   approx = f32(S_0)*w_0;  approx = approx + f32(S_p)*w_p  (p = 1..P-1)
// then  approx / d  >  0.05*(t_i + t_j)*SLACK_REL - SLACK_ABS, the order
// ops/pairwise.py's approx_dot_f32 and retention_mask write. Every float
// step is an explicitly rounded intrinsic (__int2float_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn, __fsub_rn), so nvcc cannot contract to FMA and the
// result is bit-equal to the plain PyTorch version; both epilogues run the
// one test below, so COUNT's and APPEND's counts agree bit for bit. When d
// is a power of two the quotient is __fmul_rn(approx, 1/d): 1/d is exact in
// float32 and both forms round the same real number once, so it equals
// __fdiv_rn(approx, d) and leaves out __fdiv_rn's slow-path call (kPow2).
// Never build this file with --use_fast_math. Integer sums are exact in any
// order, so the counts do not depend on how the tiles are split into work
// items: the TPU kernel's VMEM sub-blocks have no counterpart here.
//
// What bounds it on the H100: the int8 tensor cores, 2 P d operations a
// pair at 1,979 TOP/s (16 tiles of 2048^2 at P = 3, d = 2048: 0.417 ms),
// and next the L2 that feeds them (the planes of a 16-tile sweep, 48 MB,
// sit in the 50 MB L2). APPEND's survivors are few (a few per million
// pairs at the main path's density), so its writes do not count.
//
// Design:
// - CTA tile 128 x 128: two consumer warpgroups of 64 rows each run
//   wgmma.m64n128k32.s32.s8.s8 (64 int32 accumulators a thread), so the
//   float32 plane combine lives in 64 more registers a thread, not in
//   shared memory, and the ring gets the shared memory: 6 stages of 128
//   bytes of K in the 128-byte swizzle (A 128 x 128 B + B 128 x 128 B =
//   32 KB a stage, four k32 wgmmas; 64-byte stages, with twice the barrier
//   and release work a MAC, ran slower on the H100: PERF.md). A d_pad
//   that is an odd multiple of 64 reads its last stage's upper half past
//   the planes' columns, which the TMA fills with zeros.
// - Clusters of 2 x 2 CTAs compute 256 x 256 blocks. The two CTAs of a row
//   share their 128 rows of A, the two of a column their 128 rows of B:
//   each CTA loads one 64-row half of each, multicast to its partner, so a
//   CTA pulls half its stage (16 KB) from L2. A stage is refilled once the
//   consumers of every CTA that writes into it (its row and column
//   partners and itself) have released it: its empty barrier counts 3 x 8
//   warps.
// - Persistent: the grid holds as many clusters as fit on the card at once
//   (cudaOccupancyMaxActiveClusters, once per device and instance);
//   cluster c walks the work items c, c + G, ... of the list, an item being
//   one 256 x 256 block of one tile. The producer walks the same items, so
//   the ring stays full across items: item n+1's loads overlap item n's
//   epilogue, and nothing is set up per block.
// - MMAs in flight: each K step commits its four wgmmas as one group, waits
//   for the PREVIOUS group (wait_group 1) and releases that group's stage;
//   a plane ends with wait_group 0 and the fold. The two consumer
//   warpgroups share no barrier but the ring, so while one folds or runs
//   its epilogue the other keeps the tensor cores busy.
// - No masked columns: an item's CTAs are 128 x 128 and every tile edge is
//   a multiple of 128, so only a tile edge that is an odd multiple of 128
//   leaves its last items a dead 128-row or 128-column half, which loads
//   and multiplies (its partner needs the half it shares) and counts and
//   writes nothing.
// - Epilogue: the CTA block's 128 row and 128 column thresholds are
//   prefetched into L1 when an item starts; after the last fold each
//   thread reads its 2 row and 32 column thresholds (registers the
//   accumulators no longer need) and tests its 64 pairs into two 32-bit
//   words of pass bits (APPEND's self mask, row == column + diag_offset,
//   reduced to one 32-bit compare a pair); the warp adds its survivors to
//   counts[tile] with one atomicAdd. APPEND then compacts, only in warps
//   that hold a survivor: per pass-bit slot one __ballot_sync, __popc for
//   the in-warp rank and ONE atomicAdd per warp on the running total, an
//   8-byte store per survivor. The compaction loop stays rolled (unrolled
//   64 times, kernel S's ran ~20% slower: PERF.md). The total keeps
//   counting past `cap` (writes stop there), so the caller learns the
//   exact size to rerun with. Pad rows carry t = 1e30 and never pass.
// - ptxas (CUDA 12.8, sm_90a, -Xptxas -v), every instance 168 registers
//   at launch (40 / 232 after setmaxnreg), dynamic shared memory 197,728
//   B: one CTA per SM. The kPow2 instances (d = 2048 on the main path): no
//   spills, a 64-byte stack frame (the plane weights). The __fdiv_rn
//   instances spill around its slow-path call: COUNT 120 B stored / 156 B
//   loaded, APPEND 68 / 100 B (and ran 15% / 11% slower: PERF.md).
// - The tile list lives on the device: (n_tiles, 2) int32 (row tile,
//   column tile) coordinates, or, for COUNT without a list, the dense grid
//   of row tiles [row_t0, ...) x n_col_tiles column tiles (sweep_counts).
//
// wgmma accumulator layout (m64nNk32, s32): warp w of a consumer warpgroup
// owns rows 16w + g and 16w + g + 8 (g = lane / 4) of the warpgroup's 64;
// accumulator 4j + e is column 8j + 2(lane % 4) + (e & 1) of row +8 (e >> 1).
#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;     // CTA rows: two consumer warpgroups of 64
constexpr int kBN = 128;     // CTA columns: the wgmma N
constexpr int kBK = 128;     // K bytes of a stage (one swizzle span)
constexpr int kKSteps = kBK / 32;  // wgmma k32 steps a stage
constexpr int kCR = 2;       // CTAs of a cluster along the rows
constexpr int kCC = 2;       // ... and along the columns
constexpr int kCluster = kCR * kCC;
constexpr int kABox = kBM / kCC;  // rows of A a CTA loads (and multicasts)
constexpr int kBBox = kBN / kCR;  // rows of B a CTA loads (and multicasts)
constexpr int kWriters = kCR + kCC - 1;  // CTAs that write into a CTA's ring
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kAcc = kBN / 2;               // int32 accumulators a thread
constexpr int kATile = kBM * kBK;           // A: 128 rows of a stage
constexpr int kBTile = kBN * kBK;           // B: 128 rows of a stage
constexpr int kStageBytes = kATile + kBTile;
constexpr int kStages = 6;
constexpr int kBarOffset = kStages * kStageBytes;
// + the full and empty barriers, + slack to align the base to 1024 bytes
constexpr int kBytes = kBarOffset + 2 * kStages * 8 + 1024;

// The quotient approx / d as __fmul_rn(approx, 1/d) when d is a power of two
// (bit-equal, see the note above); false sends every d to the __fdiv_rn
// instances (the variant PERF.md times this choice against).
constexpr bool kPow2Div = true;

struct Args {
  const float* thr_i;
  const float* thr_j;
  const int32_t* coords;  // (n_tiles, 2), or null: the dense grid
  int32_t* counts;
  int P;
  int nk;  // K steps of kBK bytes
  float dval, inv_d, slack_rel, slack_abs;  // inv_d: 1/d (kPow2 instances)
  int tile_r, tile_c;
  int row_t0, n_col_tiles;  // the dense grid (coords == null)
  int nbr, nbc;             // cluster blocks of a tile: rows, columns
  int n_items;              // n_tiles x nbr x nbc (32-bit: no division call)
  // APPEND: the self mask (row == column + diag_offset) and the survivors'
  // buffer of `cap` (row, column) pairs with its running total
  int mask_self;
  long long diag_offset;
  int2* rc;
  unsigned* total;
  long long cap;
};

// one box of plane `plane` at (k bytes, row) into the CTAs of `mask` (same
// shared memory offset, each CTA's own barrier at `bar`'s offset)
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int k,
                                                   int row, int plane,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(k),
      "r"(row), "r"(plane)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of kBK-byte rows in the
// kBK-byte swizzle (layout type 2 for 64 bytes, 1 for 128): 8-row groups
// 8 kBK bytes apart (SBO), LBO unused (1). Adding 2 moves the start 32
// bytes along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * kBK / 16) << 32) |
         (static_cast<uint64_t>(kBK == 64 ? 2 : 1) << 62);
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 int32, this thread's 64) = A (64 x 32 B) . B (128 x 32 B)^T
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[kAcc], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One CTA's share of a work item: its tile, first row of A and first
// column (row of B), and whether its 128 x 128 block lies inside the tile.
struct Item {
  int tile, row0, col0;
  bool live;
};

// item `it` for the CTA at (r, c) of its cluster: item = tile * (nbr *
// nbc) + block row * nbc + block column, so the clusters working at once
// share the rows and columns of one tile in the L2
__device__ __forceinline__ Item item_at(const Args& a, int it, int r, int c) {
  const int per = a.nbr * a.nbc;
  const int tile = it / per, b = it % per;
  int tr, tc;
  if (a.coords) {
    tr = a.coords[2 * tile];
    tc = a.coords[2 * tile + 1];
  } else {
    tr = a.row_t0 + tile / a.n_col_tiles;
    tc = tile % a.n_col_tiles;
  }
  const int rin = (b / a.nbc) * kCR * kBM + r * kBM;
  const int cin = (b % a.nbc) * kCC * kBN + c * kBN;
  return {tile, tr * a.tile_r + rin, tc * a.tile_c + cin,
          rin < a.tile_r && cin < a.tile_c};
}

// APPEND's compaction of one warp's pass bits (bit e of word w: accumulator
// 32 w + e): per slot one ballot and, where the slot holds survivors, one
// atomicAdd on the total for the warp; writes stop at cap.
__device__ __forceinline__ void compact(const Args& a, const Item& item,
                                        const unsigned (&bits)[kAcc / 32],
                                        int rbase, int t, int lane) {
#pragma unroll
  for (int w = 0; w < kAcc / 32; ++w) {
#pragma unroll 1
    for (int e = 0; e < 32; ++e) {
      const bool pass = (bits[w] >> e) & 1u;
      const unsigned m = __ballot_sync(kFullMask, pass);
      if (!m) continue;  // warp-uniform
      unsigned base = 0;
      if (lane == 0) base = atomicAdd(a.total, (unsigned)__popc(m));
      base = __shfl_sync(kFullMask, base, 0);
      const unsigned long long pos =
          (unsigned long long)base + __popc(m & ((1u << lane) - 1u));
      if (pass && pos < (unsigned long long)a.cap) {
        const int i = 32 * w + e;
        a.rc[pos] = make_int2(item.row0 + rbase + 8 * ((i >> 1) & 1),
                              item.col0 + 8 * (i >> 2) + 2 * t + (i & 1));
      }
    }
  }
}

// The consumer warpgroups: every item of this cluster, plane after plane,
// K step after K step, the float32 fold at each plane's end and the
// retention test, the count and (APPEND) the compaction at the item's end.
template <bool kAppend, bool kPow2>
__device__ __forceinline__ void consume(const Args& a, const Weights& wts,
                                        uint32_t a_smem, uint32_t b_smem,
                                        uint32_t full, uint32_t empty, int r,
                                        int c, int cluster, int n_clusters) {
  const int ct = threadIdx.x, wg = ct >> 7, lane = ct & 31;
  const int t = lane & 3;
  // this thread's rows of the CTA block: rbase and rbase + 8
  const int rbase = wg * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  // a stage is free once the consumers of every CTA that writes into it are
  // done with it: one arrive per warp on each writer's empty barrier (the
  // CTAs of this one's row and column, itself once)
  auto release = [&](int st) {
    if (lane == 0) {
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc)
        mbar_arrive_cluster(empty + 8 * st, r * kCC + cc);
#pragma unroll
      for (int rr = 0; rr < kCR; ++rr)
        if (rr != r) mbar_arrive_cluster(empty + 8 * st, rr * kCC + c);
    }
  };
  int acc[kAcc];
  float approx[kAcc];
  int s = 0;
  uint32_t ph = 0;
  for (int it = cluster; it < a.n_items; it += n_clusters) {
    const Item item = item_at(a, it, r, c);
    // the epilogue's thresholds (the CTA block's 128 columns and 128 rows,
    // 8 lines of 128 bytes) into L1 now; read after the last fold
    if (item.live && ct < 8)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(
          ct < 4 ? a.thr_j + item.col0 + 32 * ct
                 : a.thr_i + item.row0 + 32 * (ct - 4)));
    for (int p = 0; p < a.P; ++p) {
      int prev = -1;
      for (int k = 0; k < a.nk; ++k) {
        mbar_wait(full + 8 * s, ph);
        const uint64_t da = smem_desc(a_smem + s * kATile + wg * 64 * kBK);
        const uint64_t db = smem_desc(b_smem + s * kBTile);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKSteps; ++j)
          wgmma_m64n128k32(acc, da + 2 * j, db + 2 * j, k > 0 || j > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: free its stage
        if (prev >= 0) release(prev);
        prev = s;
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      release(prev);
      fence_acc(acc);
      // fold plane p into the float32 combine, in plane order
      const float w = wts.w[p];
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
          approx[i] = __fmul_rn(__int2float_rn(acc[i]), w);
      } else {
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
          approx[i] =
              __fadd_rn(approx[i], __fmul_rn(__int2float_rn(acc[i]), w));
      }
    }
    if (!item.live) continue;
    const float ti[2] = {__ldg(a.thr_i + item.row0 + rbase),
                         __ldg(a.thr_i + item.row0 + rbase + 8)};
    float tj[kAcc / 2];
#pragma unroll
    for (int j = 0; j < kAcc / 2; ++j)
      tj[j] = __ldg(a.thr_j + item.col0 + 8 * (j >> 1) + 2 * t + (j & 1));
    // APPEND's self mask: accumulator i (row +8h, column 8j + e) is the
    // pair r == c + diag_offset when self == 8j + e - 8h (a value in
    // [-8, 127]; any other value masks nothing)
    int self = INT_MIN;
    if (kAppend && a.mask_self) {
      const long long o = (long long)item.row0 + rbase - item.col0 - 2 * t -
                          a.diag_offset;
      if (o >= -8 && o < kBN) self = (int)o;
    }
    static_assert(kAcc == 64, "two words of pass bits a thread");
    unsigned bits[kAcc / 32];
#pragma unroll
    for (int w = 0; w < kAcc / 32; ++w) {
      unsigned word = 0;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = 32 * w + e;
        const float q = kPow2 ? __fmul_rn(approx[i], a.inv_d)
                              : __fdiv_rn(approx[i], a.dval);
        float th = __fadd_rn(ti[(i >> 1) & 1], tj[2 * (i >> 2) + (i & 1)]);
        th = __fmul_rn(0.05f, th);
        th = __fmul_rn(th, a.slack_rel);
        th = __fsub_rn(th, a.slack_abs);
        const bool pass =
            q > th && self != 8 * (i >> 2) + (i & 1) - 8 * ((i >> 1) & 1);
        word |= (unsigned)pass << e;
      }
      bits[w] = word;
    }
    if (kAppend && __any_sync(kFullMask, bits[0] | bits[1]))
      compact(a, item, bits, rbase, t, lane);
    const int cnt =
        __reduce_add_sync(kFullMask, __popc(bits[0]) + __popc(bits[1]));
    if (lane == 0 && cnt) atomicAdd(&a.counts[item.tile], cnt);
  }
}

template <bool kAppend, bool kPow2>
__global__ void __launch_bounds__(kThreads, 1)
    retention_kernel(const __grid_constant__ CUtensorMap map_i,
                     const __grid_constant__ CUtensorMap map_j, const Args a,
                     const Weights wts) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_smem = base, b_smem = base + kStages * kATile;
  const uint32_t full = base + kBarOffset, empty = full + 8 * kStages;

  // CTA (r, c) of its cluster computes rows r and columns c of the
  // cluster's 256 x 256 block
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int r = (int)rank / kCC, c = (int)rank % kCC;
  const int cluster = blockIdx.x / kCluster,
            n_clusters = gridDim.x / kCluster;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWriters * kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync_aligned();

  // Both roles end in a cluster barrier: no CTA exits while a partner may
  // still multicast into it or arrive on its barriers.
  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full, item after item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const uint16_t row_mask = (uint16_t)(((1u << kCC) - 1u) << (r * kCC));
      uint16_t col_mask = 0;
      for (int rr = 0; rr < kCR; ++rr)
        col_mask |= (uint16_t)(1u << (rr * kCC + c));
      int s = 0;
      uint32_t ph = 0;
      for (int it = cluster; it < a.n_items; it += n_clusters) {
        const Item item = item_at(a, it, r, c);
        for (int p = 0; p < a.P; ++p)
          for (int k = 0; k < a.nk; ++k) {
            mbar_wait(empty + 8 * s, ph ^ 1);
            const uint32_t bar = full + 8 * s;
            mbar_expect_tx(bar, kStageBytes);
            tma_load_multicast(a_smem + s * kATile + c * kABox * kBK, &map_i,
                               bar, k * kBK, item.row0 + c * kABox, p,
                               row_mask);
            tma_load_multicast(b_smem + s * kBTile + r * kBBox * kBK, &map_j,
                               bar, k * kBK, item.col0 + r * kBBox, p,
                               col_mask);
            if (++s == kStages) {
              s = 0;
              ph ^= 1;
            }
          }
      }
    }
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    consume<kAppend, kPow2>(a, wts, a_smem, b_smem, full, empty, r, c,
                            cluster, n_clusters);
    cluster_sync();
  }
}

// The map of (P, rows, d_pad) int8 planes in boxes of kBK bytes x `box`
// rows with the kBK-byte swizzle; rows and columns past the planes read as
// zeros. Returns a cudaError_t.
int plane_map(CUtensorMap* map, const void* base, int P, long long rows,
              int d_pad, int box) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d_pad, (cuuint64_t)rows,
                              (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)d_pad,
                                 (cuuint64_t)(rows * d_pad)};
  const cuuint32_t boxes[3] = {kBK, (cuuint32_t)box, 1};  // past d_pad: 0
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kBK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

cudaLaunchConfig_t launch_config(long long grid, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of one instance that fit on `device` at once (its shared memory
// attribute set on the way), queried once per device and instance.
template <bool kAppend, bool kPow2>
int max_clusters(int device, int* out) {
  static int cache[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (cache[device] > 0) {
    *out = cache[device];
    return 0;
  }
  const auto kernel = retention_kernel<kAppend, kPow2>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(kCluster, nullptr, &attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaErrorInvalidConfiguration;
  cache[device] = n;
  *out = n;
  return 0;
}

template <bool kAppend, bool kPow2>
int launch(const CUtensorMap& mi, const CUtensorMap& mj, const Args& a,
           const Weights& w, cudaStream_t stream) {
  int device = 0, clusters = 0;
  int err = (int)cudaGetDevice(&device);
  if (!err) err = max_clusters<kAppend, kPow2>(device, &clusters);
  if (err) return err;
  const long long grid =
      (long long)kCluster * (a.n_items < clusters ? a.n_items : clusters);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, retention_kernel<kAppend, kPow2>, mi, mj, a, w);
  if (e != cudaSuccess) return (int)e;
  return mvs_launch_status();
}

// The operands both entries share, checked, into `a` and the two tensor
// maps; -> a cudaError_t, or -1 when the list holds no work item.
int prepare(Args* a, CUtensorMap* mi, CUtensorMap* mj, const void* planes_i,
            const void* planes_j, const void* thr_i, const void* thr_j, int P,
            int d, int d_pad, long long rows_i, long long rows_j,
            const void* coords, int n_tiles, int tile_r, int tile_c,
            float slack_rel, float slack_abs, void* counts) {
  if (P < 1 || P > kMaxPlanes || d <= 0 || tile_r <= 0 || tile_c <= 0 ||
      tile_r % kBM || tile_c % kBN || d_pad <= 0 || d_pad % 64 ||
      n_tiles < 0 || rows_i < tile_r || rows_j < tile_c ||
      rows_i > INT_MAX || rows_j > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a->nbr = (tile_r + kCR * kBM - 1) / (kCR * kBM);
  a->nbc = (tile_c + kCC * kBN - 1) / (kCC * kBN);
  const long long n_items = (long long)n_tiles * a->nbr * a->nbc;
  if (n_items > INT_MAX) return (int)cudaErrorInvalidValue;
  a->n_items = (int)n_items;
  if (n_items == 0) return -1;
  int err = plane_map(mi, planes_i, P, rows_i, d_pad, kABox);
  if (!err) err = plane_map(mj, planes_j, P, rows_j, d_pad, kBBox);
  if (err) return err;
  a->thr_i = (const float*)thr_i;
  a->thr_j = (const float*)thr_j;
  a->coords = (const int32_t*)coords;
  a->counts = (int32_t*)counts;
  a->P = P;
  a->nk = (d_pad + kBK - 1) / kBK;
  a->dval = (float)d;
  // 1/d, exact in float32 for a power of two; 0 selects __fdiv_rn
  a->inv_d = kPow2Div && (d & (d - 1)) == 0 ? 1.0f / (float)d : 0.0f;
  a->slack_rel = slack_rel;
  a->slack_abs = slack_abs;
  a->tile_r = tile_r;
  a->tile_c = tile_c;
  return 0;
}

template <bool kAppend>
int run(const CUtensorMap& mi, const CUtensorMap& mj, const Args& a,
        const void* weights_host, int P, void* stream) {
  const Weights w = load_weights(weights_host, P);
  return a.inv_d != 0.0f
             ? launch<kAppend, true>(mi, mj, a, w, (cudaStream_t)stream)
             : launch<kAppend, false>(mi, mj, a, w, (cudaStream_t)stream);
}

}  // namespace

// planes_*: (P, rows_*, d_pad) int8, contiguous; thr_*: (rows_*,) float32
// squared-norm thresholds (1e30 on pad rows); coords: (n_tiles, 2) int32
// (row tile of planes_i, column tile of planes_j) on the device, or null
// for the dense grid of row tiles [row_t0, row_t0 + n_tiles / n_col_tiles)
// x n_col_tiles column tiles; tiles are tile_r x tile_c (multiples of 128)
// and lie inside the planes (the caller checks); weights_host: P float32 on
// the HOST. counts: (n_tiles,) int32, zeroed by the caller.
MVS_EXPORT int mvs_count(const void* planes_i, const void* planes_j,
                         const void* thr_i, const void* thr_j, int P, int d,
                         int d_pad, long long rows_i, long long rows_j,
                         const void* coords, int n_tiles, int row_t0,
                         int n_col_tiles, int tile_r, int tile_c,
                         const void* weights_host, float slack_rel,
                         float slack_abs, void* counts, void* stream) {
  if (!coords && (n_col_tiles <= 0 || row_t0 < 0))
    return (int)cudaErrorInvalidValue;
  Args a{};
  CUtensorMap mi, mj;
  const int err = prepare(&a, &mi, &mj, planes_i, planes_j, thr_i, thr_j, P,
                          d, d_pad, rows_i, rows_j, coords, n_tiles, tile_r,
                          tile_c, slack_rel, slack_abs, counts);
  if (err) return err < 0 ? mvs_launch_status() : err;
  a.row_t0 = row_t0;
  a.n_col_tiles = n_col_tiles;
  return run<false>(mi, mj, a, weights_host, P, stream);
}

// APPEND over the tile list coords ((n_tiles, 2) int32 on the device, as
// mvs_count's): counts as mvs_count's, plus rc: (cap, 2) int32 and total:
// one uint32, counts and total zeroed by the caller. mask_self drops the
// pairs whose row index equals column index + diag_offset: 0 when both
// operands share one row numbering, the column operand's first global row
// minus the row operand's when they are two windows of one database.
MVS_EXPORT int mvs_append(const void* planes_i, const void* planes_j,
                          const void* thr_i, const void* thr_j, int P, int d,
                          int d_pad, long long rows_i, long long rows_j,
                          const void* coords, int n_tiles, int tile_r,
                          int tile_c, const void* weights_host,
                          float slack_rel, float slack_abs, int mask_self,
                          long long diag_offset, void* counts, void* rc,
                          void* total, long long cap, void* stream) {
  if (!coords || cap < 0) return (int)cudaErrorInvalidValue;
  Args a{};
  CUtensorMap mi, mj;
  const int err = prepare(&a, &mi, &mj, planes_i, planes_j, thr_i, thr_j, P,
                          d, d_pad, rows_i, rows_j, coords, n_tiles, tile_r,
                          tile_c, slack_rel, slack_abs, counts);
  if (err) return err < 0 ? mvs_launch_status() : err;
  a.mask_self = mask_self;
  a.diag_offset = diag_offset;
  a.rc = (int2*)rc;
  a.total = (unsigned*)total;
  a.cap = cap;
  return run<true>(mi, mj, a, weights_host, P, stream);
}
