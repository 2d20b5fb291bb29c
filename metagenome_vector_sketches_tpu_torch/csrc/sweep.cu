// Kernels S and G: the port's int8 GEMM core on Hopper (a TMA ring feeding
// wgmma) with the ANN scan's and the MinHash Gram's epilogues.
//
// Kernel S (entry mvs_scan) replaces the plane GEMMs + combine + x 1/|v| of
// the XLA program metagenome_vector_sketches_tpu/ann/int_index.py:124
// _int_scan_pool (its SCORE epilogue). Kernel G (entry mvs_gram_rows)
// replaces the XLA program metagenome_vector_sketches_tpu/ops/minhash.py:47
// _chunk_gram: it computes one shard's rows of the heavy-hash Gram
// (ops/minhash.py). The thresholded sweeps (the survivor counts of the repo's
// one Pallas kernel, ops/pallas_pairwise.py:55 pallas_sweep_counts, and
// the survivor compaction of ops/pairwise.py:635 sweep_extract_fused_ij)
// are kernels COUNT and APPEND, count.cu.
//
// Math of S, per (query row, database column) pair: P int8 x int8 -> int32
// plane products (exact), combined in float32 in plane order,
//   approx = f32(S_0)*w_0;  approx = approx + f32(S_p)*w_p  (p = 1..P-1)
// then  score = approx * inv_n[c], the order ops/pairwise.py's
// approx_dot_f32 and scan_scores_plain write. Every float step is an
// explicitly rounded intrinsic (__int2float_rn, __fmul_rn, __fadd_rn), so
// nvcc cannot contract to FMA and the result is bit-equal to the plain
// PyTorch version, which runs the same eager float32 ops in the same
// order. Integer MMAs are exact in any order. Never build this file with
// --use_fast_math. G: c[i, j] = sum_k a[row0 + i, k] a[j, k] for the rows
// of one shard of an (n, u) 0/1 int8 incidence, int32 (a count is at most
// u).
//
// What bounds them on the H100: the int8 tensor cores (1,979 TOP/s dense)
// and, next, the L2 that feeds them. At d = 2048 the operands come from L2;
// a 128 x 128 CTA tile asks about 15 TB/s of it at peak, a 128 x 256 tile
// 11.5 TB/s. The design cuts that in two ways (wider tile, operands shared
// between two CTAs) and hides the L2 latency behind a ring of stages. The
// ANN scan (SCORE) also reads its whole database chunk once from device
// memory, which bounds it by bytes (PERF.md).
//
// Design (one template, gemm_kernel<kMode>, for S and G):
// - CTA tile 128 rows x 256 columns; 384 threads: warpgroups 0 and 1
//   consume (each 64 rows x 256 columns with wgmma.m64n256k32.s32.s8.s8,
//   128 int32 accumulators a thread), warpgroup 2 produces (one thread
//   issues the TMA loads). setmaxnreg moves registers from the producer
//   (40) to the consumers (232).
// - Clusters of two CTAs compute the two 128-row halves of a 256 x 256
//   block. Each CTA loads its own A (128 rows) and one 128-row half of B,
//   multicast into both CTAs' shared memory, so a CTA pulls 16 KB from L2
//   per stage instead of 24 KB; a stage is refilled once the consumers of
//   both CTAs have released it (their empty barriers count 16 warps).
// - K steps of 64 bytes, one 64-byte swizzle span: a stage is A 128 x 64 B
//   and B 256 x 64 B, 24 KB, filled by cp.async.bulk.tensor (3-D maps over
//   (P, rows, d_pad), boxes of 64 B x 128 rows, rows past the operand
//   zero-filled) and signalled through a full/empty mbarrier pair. The
//   producer walks plane after plane without draining the ring, so plane
//   p's fold overlaps plane p+1's loads. Every d_pad that is a multiple of
//   64 takes whole stages (an odd number of 64-byte steps too).
// - Registers of S (255 a thread at most): an m64n256 tile needs 128 int32
//   registers for the current plane and 128 float32 for approx; both do
//   not fit. approx therefore lives in shared memory, 128 x 256 x 4 B =
//   128 KB, one column per consumer thread (conflict-free): at each plane
//   boundary a thread folds its 128 accumulators into it, and the last
//   plane's fold stays in the accumulator registers for the epilogue. That
//   leaves a ring of 4 stages (96 KB). G keeps only the int32 set and
//   takes a ring of 8 stages (192 KB).
// - Epilogue inputs: S's consumers copy the block's 256 inv_n values into
//   shared memory before the main loop, so the epilogue reads no global
//   memory; G stores its counts without reading c.
// - Column blocks of S past the scan's width mask their columns; row
//   blocks with an odd number of 128-row blocks leave the last pair's
//   second CTA without rows of its own (it only feeds its peer).
// - ptxas (CUDA 12.8, sm_90a, -Xptxas -v): every instance 168 registers at
//   launch (384 threads; 40 / 232 after setmaxnreg), no spills, a 64-byte
//   stack frame for S's plane weights. Dynamic shared memory: S 231,488 B
//   (ring 96 KB, approx 128 KB, inv_n table 1 KB, barriers, 1 KB alignment
//   slack), G 197,760 B: one CTA per SM.
//
// Epilogues (template parameter), on the wgmma accumulator layout: warp w
// of a consumer warpgroup owns rows 16w + g and 16w + g + 8 (g = lane / 4)
// of the warpgroup's 64; accumulator 4j + e is column 8j + 2(lane % 4) +
// (e & 1) of row +8 * (e >> 1).
//   SCORE  — rows are query planes, columns one chunk of the database
//            stack; every pair's combined dot times inv_n[c] (one more
//            __fmul_rn) is written to a row-major float32 (rows, ld) score
//            matrix, -inf on columns c >= valid.
//   ROWS   — (G) rows are one shard's rows of the incidence, columns every
//            row of it; c[r, col] = the int32 count (stored, not added:
//            the shard's accumulator starts here), columns past the
//            width masked as SCORE masks them. SCORE's rectangular grid.
#include <cuda.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;     // CTA rows: two consumer warpgroups of 64
constexpr int kBN = 256;     // CTA columns: the wgmma N
constexpr int kBK = 64;      // K bytes of a stage (the 64-byte swizzle span)
constexpr int kBox = 128;    // rows of one TMA box (SWEEP_BLOCK)
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kAcc = kBN / 2;               // int32 accumulators a thread
constexpr int kATile = kBM * kBK;           // 8 KB
constexpr int kBTile = kBN * kBK;           // 16 KB
constexpr int kStageBytes = kATile + kBTile;

// the values name the instances in a trace: gemm_kernel<4> is kernel G
enum Epilogue { kScore = 2, kRows = 4 };

// G keeps only the int32 accumulators
constexpr bool int_only(int mode) { return mode != kScore; }

template <int kMode>
struct Layout {
  static constexpr int kStages = int_only(kMode) ? 8 : 4;
  static constexpr int kApproxBytes =
      int_only(kMode) ? 0 : kAcc * kConsumers * 4;
  // S: the block's inv_n values
  static constexpr int kTableBytes = int_only(kMode) ? 0 : kBN * 4;
  static constexpr int kBarOffset =
      kStages * kStageBytes + kApproxBytes + kTableBytes;
  // + the full and empty barriers, + slack to align the base to 1024 bytes
  static constexpr int kBytes = kBarOffset + 2 * kStages * 8 + 1024;
};

// The operands of one launch: SCORE reads inv_n, valid, scores, ld (its
// grid covers one tile_r x tile_c block); ROWS (G) reads c, ldc on the
// same grid.
struct Args {
  int P;
  int nk;  // K steps of kBK bytes
  int tile_r, tile_c;
  const float* inv_n;
  int valid;
  float* scores;
  long long ld;
  int32_t* c;
  long long ldc;
};

// one 64-byte x 128-row box of plane `plane` at (k bytes, row) -> smem dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(row),
      "r"(plane)
      : "memory");
}

// the same box into both CTAs of the cluster (same smem offset, each CTA's
// own barrier at `bar`'s offset)
__device__ __forceinline__ void tma_load_pair(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int k, int row,
                                              int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"((uint16_t)3),
      "r"(k), "r"(row), "r"(plane)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 64-byte rows in the
// 64-byte swizzle (layout type 2): 8-row groups 512 bytes apart (SBO), LBO
// unused (1). Adding 2 moves the start 32 bytes along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * kBK / 16) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_acc(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256 int32, this thread's 128) = A (64 x 32 B) . B (256 x 32 B)^T
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[kAcc], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The consumer warpgroups: the main loop over P planes x nk K steps, the
// plane folds (S) and the epilogue, for the CTA block at (row0, col0) with
// col_lim valid columns; a CTA that is not `live` (the pair's second block
// past an odd number of 128-row blocks) only feeds its peer.
template <int kMode, int kStages>
__device__ __forceinline__ void consume(const Args& args, const Weights& wts,
                                        uint32_t a_smem, uint32_t b_smem,
                                        float* approx, uint32_t full,
                                        uint32_t empty, int row0, int col0,
                                        int col_lim, bool live) {
  const int ct = threadIdx.x, wg = ct >> 7, lane = ct & 31;
  const int t = lane & 3;
  // this thread's rows of the CTA block: rbase and rbase + 8
  const int rbase = wg * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  int acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;

  // S stages the values its epilogue reads into shared memory now, so the
  // loads overlap the main loop: one column per thread (kBN == kConsumers)
  static_assert(kBN == kConsumers, "one table column per consumer thread");
  float* table = approx + kAcc * kConsumers;
  if (kMode == kScore && live) {
    const int gc = col0 + ct;
    table[ct] = gc < args.valid ? args.inv_n[gc] : 0.f;
  }

  // a stage is free once both CTAs' consumers are done with it (the peer
  // multicasts its B half into this CTA's copy): one arrive per warp on
  // each CTA's empty barrier
  auto release = [&](int st) {
    if (lane == 0) {
      mbar_arrive_cluster(empty + 8 * st, 0);
      mbar_arrive_cluster(empty + 8 * st, 1);
    }
  };
  int s = 0;
  uint32_t ph = 0;
  for (int p = 0; p < args.P; ++p) {
    for (int k = 0; k < args.nk; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint64_t da = smem_desc(a_smem + s * kATile + wg * 64 * kBK);
      const uint64_t db = smem_desc(b_smem + s * kBTile);
      wgmma_fence();
      wgmma_m64n256k32(acc, da, db, k > 0);
      wgmma_m64n256k32(acc, da + 2, db + 2, 1);
      wgmma_commit();
      wgmma_wait_all();
      release(s);
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    fence_acc(acc);
    if (kMode == kScore) {
      // fold plane p into the float32 combine, in plane order; the last
      // plane's sum stays in acc (as float bits) for the epilogue
      const float w = wts.w[p];
      float* ap = approx + ct;
      if (p + 1 < args.P) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const float term = __fmul_rn(__int2float_rn(acc[i]), w);
          ap[i * kConsumers] =
              p == 0 ? term : __fadd_rn(ap[i * kConsumers], term);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const float term = __fmul_rn(__int2float_rn(acc[i]), w);
          acc[i] = __float_as_int(
              p == 0 ? term : __fadd_rn(ap[i * kConsumers], term));
        }
      }
    }
  }

  if (!live) return;
  if (kMode == kRows) {
#pragma unroll
    for (int u = 0; u < kAcc / 2; ++u) {
      const int cl = 8 * (u >> 1) + 2 * t;
      if (cl >= col_lim) continue;
      const long long gr = row0 + rbase + 8 * (u & 1);
      *reinterpret_cast<int2*>(&args.c[gr * args.ldc + col0 + cl]) =
          make_int2(acc[2 * u], acc[2 * u + 1]);
    }
    return;
  }

  // the table is written by all consumer threads
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int u = 0; u < kAcc / 2; ++u) {
    const int cl = 8 * (u >> 1) + 2 * t;
    if (cl >= col_lim) continue;
    const int gc = col0 + cl;
    const long long gr = row0 + rbase + 8 * (u & 1);
    float2 x;
    x.x = gc < args.valid
              ? __fmul_rn(__int_as_float(acc[2 * u]), table[cl])
              : -INFINITY;
    x.y = gc + 1 < args.valid
              ? __fmul_rn(__int_as_float(acc[2 * u + 1]), table[cl + 1])
              : -INFINITY;
    *reinterpret_cast<float2*>(&args.scores[gr * args.ld + gc]) = x;
  }
}

template <int kMode>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_i,
                const __grid_constant__ CUtensorMap map_j, const Args args,
                const Weights wts) {
  using Lay = Layout<kMode>;
  constexpr int S = Lay::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t a_smem = base, b_smem = base + S * kATile;
  float* approx = reinterpret_cast<float*>(smem + S * kStageBytes);
  const uint32_t full = base + Lay::kBarOffset, empty = full + 8 * S;

  // The cluster's two CTAs compute the two 128-row halves of one 256 x 256
  // block: the same 256 columns (B), rows 128 apart (A). Each loads its A
  // and one 128-row half of B, multicast into both.
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int pair = blockIdx.x >> 1;
  const int sub_c = (args.tile_c + kBN - 1) / kBN;
  const int row0 = (pair / sub_c) * 2 * kBM + rank * kBM;
  const int col0 = (pair % sub_c) * kBN;
  const int col_lim = min(kBN, args.tile_c - col0);
  const bool live = row0 < args.tile_r;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync_aligned();

  // Both roles end in a cluster barrier: no CTA exits while its peer may
  // still arrive on its barriers.
  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full, plane after plane
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int s = 0;
      uint32_t ph = 0;
      for (int p = 0; p < args.P; ++p)
        for (int k = 0; k < args.nk; ++k) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, kStageBytes);
          tma_load(a_smem + s * kATile, &map_i, bar, k * kBK, row0, p);
          tma_load_pair(b_smem + s * kBTile + rank * kBox * kBK, &map_j, bar,
                        k * kBK, col0 + rank * kBox, p);
          if (++s == S) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    consume<kMode, S>(args, wts, a_smem, b_smem, approx, full, empty, row0,
                      col0, col_lim, live);
    cluster_sync();
  }
}

// The map of (P, rows, d_pad) int8 planes, plane stride `stride` bytes, in
// boxes of 64 bytes x 128 rows with the 64-byte swizzle; rows past `rows`
// read as zeros. Returns a cudaError_t.
int plane_map(CUtensorMap* map, const void* base, int P, long long rows,
              int d_pad, long long stride) {
  const EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d_pad, (cuuint64_t)rows,
                              (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)d_pad, (cuuint64_t)stride};
  const cuuint32_t box[3] = {kBK, kBox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int kMode>
int launch(const CUtensorMap& map_i, const CUtensorMap& map_j,
           const Args& a, const Weights& w, long long grid,
           cudaStream_t stream) {
  const int bytes = Layout<kMode>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  gemm_kernel<kMode><<<(unsigned)grid, kThreads, bytes, stream>>>(map_i, map_j,
                                                                  a, w);
  return mvs_launch_status();
}

}  // namespace

// The SCORE epilogue. q_planes: (P, rows, d_pad) int8 query planes (plane
// stride stride_q); db_planes: (P, >= cols, d_pad) int8, one chunk of the
// stack (plane stride stride_db); inv_n: (cols,) float32; scores: (rows,
// ld) float32, ld >= cols and even. rows and cols are multiples of 128.
MVS_EXPORT int mvs_scan(const void* q_planes, const void* db_planes, int P,
                        int d_pad, long long stride_q, long long stride_db,
                        int rows, int cols, const void* inv_n, int valid,
                        const void* weights_host, void* scores, long long ld,
                        void* stream) {
  if (P < 1 || P > kMaxPlanes || rows <= 0 || cols <= 0 || rows % kBM ||
      cols % kBox || d_pad <= 0 || d_pad % kBK || ld < cols || ld % 2 ||
      stride_q < (long long)rows * d_pad ||
      stride_db < (long long)cols * d_pad || stride_q % kBK ||
      stride_db % kBK)
    return (int)cudaErrorInvalidValue;
  const long long grid =
      2LL * ((rows + 2 * kBM - 1) / (2 * kBM)) * ((cols + kBN - 1) / kBN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mdb;
  int err = plane_map(&mq, q_planes, P, stride_q / d_pad, d_pad, stride_q);
  if (!err) err = plane_map(&mdb, db_planes, P, stride_db / d_pad, d_pad,
                            stride_db);
  if (err) return err;
  Args a{};
  a.P = P;
  a.nk = d_pad / kBK;
  a.tile_r = rows;
  a.tile_c = cols;
  a.inv_n = (const float*)inv_n;
  a.valid = valid;
  a.scores = (float*)scores;
  a.ld = ld;
  const Weights w = load_weights(weights_host, P);
  return launch<kScore>(mq, mdb, a, w, grid, (cudaStream_t)stream);
}

// Kernel G: one shard's rows of the Gram. a: (n, ld)
// int8, row-major, n a multiple of 128 and ld of 64; rows row0 ..
// row0 + rows - 1 of it (row0 + rows <= n) against all n. c: (rows_pad, ldc)
// int32, rows_pad = rows rounded up to 128, ldc >= n and even. Stores
// c[i, j] = a[row0 + i] . a[j] for i < rows_pad (rows past `rows` read as
// zeros, so they store 0) and j < n.
MVS_EXPORT int mvs_gram_rows(const void* a, int n, int ld, int row0,
                             int rows, void* c, long long ldc, void* stream) {
  if (n <= 0 || ld <= 0 || n % kBM || ld % kBK || row0 < 0 || rows <= 0 ||
      row0 + rows > n || ldc < n || ldc % 2)
    return (int)cudaErrorInvalidValue;
  const long long rows_pad = (rows + kBM - 1) / kBM * kBM;
  const long long grid =
      2LL * ((rows_pad + 2 * kBM - 1) / (2 * kBM)) * ((n + kBN - 1) / kBN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap mi, mj;
  int err = plane_map(&mi, (const int8_t*)a + (long long)row0 * ld, 1, rows,
                      ld, (long long)rows * ld);
  if (!err) err = plane_map(&mj, a, 1, n, ld, (long long)n * ld);
  if (err) return err;
  Args args{};
  args.P = 1;
  args.nk = ld / kBK;
  args.tile_r = (int)rows_pad;
  args.tile_c = n;
  args.c = (int32_t*)c;
  args.ldc = ldc;
  const Weights w = load_weights(nullptr, 0);
  return launch<kRows>(mi, mj, args, w, grid, (cudaStream_t)stream);
}

MVS_EXPORT const char* mvs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
