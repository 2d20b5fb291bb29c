// Kernel S: the thresholded pairwise sweep over Karatsuba int8 planes.
//
// Replaces: metagenome_vector_sketches_tpu/ops/pallas_pairwise.py:55
// pallas_sweep_counts (the repo's one Pallas kernel, body _make_kernel at
// :27) in its COUNT epilogue, and the sweep + survivor compaction of the XLA
// program ops/pairwise.py:635 sweep_extract_fused_ij in its APPEND epilogue.
//
// Math, per tile of (row, column) pairs: P int8 x int8 -> int32 plane
// products (exact), combined in float32 in plane order,
//   approx = f32(S_0)*w_0;  approx = approx + f32(S_p)*w_p  (p = 1..P-1)
// then  approx / d  >  0.05*(t_i + t_j)*SLACK_REL - SLACK_ABS, the order
// ops/pairwise.py:214-236 and :346 write. Every step is an explicitly
// rounded intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsub_rn), so nvcc
// cannot contract to FMA and the result is bit-equal to the plain PyTorch
// version, which runs the same eager float32 ops in the same order. Never
// build this file with --use_fast_math.
//
// What bounds it on Hopper: the int8 tensor cores. A 128 x 128 output block
// reads 2 x 128 x d bytes per plane for 128 x 128 x d MACs (64 MAC/byte), so
// at production shapes (d = 2048) the operands come from L2 and the sweep is
// compute bound.
//
// Design (a first version, simple and exact, not yet fast): one CTA of 8
// warps per 128 x 128 sub-block; warps as 4 (rows) x 2 (cols), each owning a
// 32 x 64 block = 2 x 8 mma.sync.m16n8k32 s8 tiles with int32 accumulators.
// K steps of 64 bytes are staged through shared memory with 16-byte loads,
// rows padded to 80 bytes so the fragment reads hit 32 distinct banks.
// Planes are walked one at a time: the int32 product of plane p is exact
// before it is folded into the float32 combine, so only one int32 and one
// float32 accumulator set live in registers. No wgmma/TMA pipeline yet.
//
// Epilogues (template parameter):
//   COUNT  — K1's contract: survivors per tile, one atomicAdd per warp.
//   APPEND — per-tile counts as well, plus every survivor's global (r, c)
//            int32 written into a flat buffer of capacity `cap`: one
//            __ballot_sync per element slot, __popc for the in-warp rank and
//            ONE atomicAdd per warp on the running total. The total keeps
//            counting past `cap` (writes stop there), so the caller learns
//            the exact size to rerun with. Self-pairs can be masked:
//            r == c + diag_offset, the offset between the two operands'
//            first global rows (0 for one resident plane tensor; the
//            streaming engine passes window start - row group start).
//            Pad rows carry t = 1e30, so they never pass.
//   SCORE  — the int8 ANN engine's scan (entry mvs_scan; replaces the plane
//            GEMMs + combine + x 1/|v| of the XLA program
//            ann/int_index.py:124 _int_scan_pool): rows are query planes,
//            columns one chunk of the database stack; every pair's
//            combined dot times inv_n[c] (one more __fmul_rn) is written to
//            a row-major float32 (rows, ld) score matrix, -inf on columns
//            c >= valid. No threshold, no self mask. The top-k selection
//            stays outside the kernel (torch), so the (rows, R) scores make
//            one round trip through device memory.
//
// Kernel G (entry mvs_gram) reuses the same GEMM core (block_mma) for the
// MinHash strategy. Replaces: the XLA program
// metagenome_vector_sketches_tpu/ops/minhash.py:47 _chunk_gram, the (N, u)
// int8 0/1 incidence chunk times its transpose into int32 intersection
// counts. It adds one chunk's Gram into an int32 (n, n) accumulator on the
// device, on the upper block triangle only (the Gram is symmetric; the
// caller mirrors once after the last chunk). Exact: a count is at most u.
// What bounds it: the int8 tensor cores again (dense incidence, about 256
// ones in a 2-million-wide row, so nearly every MMA multiplies zeros); a
// sparse formulation would skip them but is not this first version.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kSRow = kBK + 16;  // padded shared-memory row (bytes)
constexpr int kThreads = 256;    // 8 warps
constexpr int kWM = 32, kWN = 64;
constexpr int kMT = kWM / 16;    // m16 tiles per warp
constexpr int kNT = kWN / 8;     // n8 tiles per warp
constexpr int kMaxPlanes = 16;

struct Weights {
  float w[kMaxPlanes];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum Epilogue { kCount = 0, kAppend = 1, kScore = 2 };

// The int8 GEMM core shared by kernels S and G: acc (this thread's share of
// a kBM x kBN block, int32) += A (kBM rows) . B (kBN rows)^T over K = ld
// bytes, both row-major with row stride ld (a multiple of kBK). K steps of
// kBK bytes are staged through As / Bs (kBM x kSRow each) with 16-byte
// loads; warps as 4 (rows) x 2 (cols), each owning a 32 x 64 block of
// mma.sync.m16n8k32 s8 tiles.
__device__ __forceinline__ void block_mma(int (&acc)[kMT][kNT][4],
                                          const int8_t* A, const int8_t* B,
                                          int ld, int8_t* As, int8_t* Bs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < ld; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 16) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, q = (c & 3) * 16;
      *reinterpret_cast<int4*>(&As[r * kSRow + q]) =
          *reinterpret_cast<const int4*>(A + (long long)r * ld + k0 + q);
      *reinterpret_cast<int4*>(&Bs[r * kSRow + q]) =
          *reinterpret_cast<const int4*>(B + (long long)r * ld + k0 + q);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned a[kMT][4], b[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int8_t* s = &As[(wm * kWM + mt * 16 + g) * kSRow + kk + t * 4];
        a[mt][0] = *reinterpret_cast<const unsigned*>(s);
        a[mt][1] = *reinterpret_cast<const unsigned*>(s + 8 * kSRow);
        a[mt][2] = *reinterpret_cast<const unsigned*>(s + 16);
        a[mt][3] = *reinterpret_cast<const unsigned*>(s + 8 * kSRow + 16);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int8_t* s = &Bs[(wn * kWN + nt * 8 + g) * kSRow + kk + t * 4];
        b[nt][0] = *reinterpret_cast<const unsigned*>(s);
        b[nt][1] = *reinterpret_cast<const unsigned*>(s + 16);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }
}

// The operands of one launch: COUNT/APPEND read thr_*, counts, rc, total,
// cap; SCORE reads inv_n, valid, scores, ld (and takes no coords: the grid
// covers the whole tile_r x tile_c block).
struct Args {
  const int8_t* planes_i;
  const int8_t* planes_j;
  const float* thr_i;
  const float* thr_j;
  int P;
  float dval;
  int d_pad;
  long long stride_i, stride_j;
  const int32_t* coords;
  int tile_r, tile_c;
  float slack_rel, slack_abs;
  int mask_self;
  long long diag_offset;
  int32_t* counts;
  int32_t* rc;
  unsigned* total;
  long long cap;
  const float* inv_n;
  int valid;
  float* scores;
  long long ld;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
sweep_kernel(const Args args, const Weights wts) {
  __shared__ __align__(16) int8_t As[kBM * kSRow];
  __shared__ __align__(16) int8_t Bs[kBN * kSRow];

  const int P = args.P, d_pad = args.d_pad;
  const int sub_c = args.tile_c / kBN;
  const int per_tile = (args.tile_r / kBM) * sub_c;
  const int tile = blockIdx.x / per_tile;
  const int sub = blockIdx.x % per_tile;
  const int tr = kMode == kScore ? 0 : args.coords[2 * tile];
  const int tc = kMode == kScore ? 0 : args.coords[2 * tile + 1];
  const int row0 = tr * args.tile_r + (sub / sub_c) * kBM;
  const int col0 = tc * args.tile_c + (sub % sub_c) * kBN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;

  float approx[kMT][kNT][4];
  for (int p = 0; p < P; ++p) {
    int acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

    block_mma(acc,
              args.planes_i + p * args.stride_i + (long long)row0 * d_pad,
              args.planes_j + p * args.stride_j + (long long)col0 * d_pad,
              d_pad, As, Bs);
    // fold plane p into the float32 combine, in plane order
    const float w = wts.w[p];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float term = __fmul_rn(__int2float_rn(acc[mt][nt][i]), w);
          approx[mt][nt][i] =
              p == 0 ? term : __fadd_rn(approx[mt][nt][i], term);
        }
  }

  if (kMode == kScore) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int gr = row0 + wm * kWM + mt * 16 + g + ((i >> 1) << 3);
          const int gc = col0 + wn * kWN + nt * 8 + t * 2 + (i & 1);
          args.scores[(long long)gr * args.ld + gc] =
              gc < args.valid ? __fmul_rn(approx[mt][nt][i], args.inv_n[gc])
                              : -INFINITY;
        }
    return;
  }

  int cnt = 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // mma C fragment: rows g / g+8, columns 2t / 2t+1
        const int gr = row0 + wm * kWM + mt * 16 + g + ((i >> 1) << 3);
        const int gc = col0 + wn * kWN + nt * 8 + t * 2 + (i & 1);
        const float q = __fdiv_rn(approx[mt][nt][i], args.dval);
        float th = __fadd_rn(args.thr_i[gr], args.thr_j[gc]);
        th = __fmul_rn(0.05f, th);
        th = __fmul_rn(th, args.slack_rel);
        th = __fsub_rn(th, args.slack_abs);
        const bool pass =
            (q > th) &&
            !(args.mask_self && (long long)gr == gc + args.diag_offset);
        cnt += pass ? 1 : 0;
        if (kMode == kAppend) {
          const unsigned m = __ballot_sync(kFullMask, pass);
          if (m) {  // warp-uniform
            unsigned base = 0;
            if (lane == 0) base = atomicAdd(args.total, (unsigned)__popc(m));
            base = __shfl_sync(kFullMask, base, 0);
            if (pass) {
              const unsigned long long pos =
                  (unsigned long long)base + __popc(m & ((1u << lane) - 1u));
              if (pos < (unsigned long long)args.cap) {
                args.rc[2 * pos] = gr;
                args.rc[2 * pos + 1] = gc;
              }
            }
          }
        }
      }
  cnt = __reduce_add_sync(kFullMask, cnt);
  if (lane == 0 && cnt) atomicAdd(&args.counts[tile], cnt);
}

// Kernel G: c[i, j] += sum_k a[i, k] * a[j, k] for an (n, ld) int8 chunk a
// into an (n, n) int32 accumulator c, on the upper block triangle only
// (block column >= block row; the caller mirrors once at the end). One CTA
// per 128 x 128 block; it alone writes its block, so the epilogue is a
// plain load, add and store.
__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const int8_t* a, int ld, int n_blocks, int32_t* c, long long ldc) {
  __shared__ __align__(16) int8_t As[kBM * kSRow];
  __shared__ __align__(16) int8_t Bs[kBN * kSRow];
  int bi = 0, k = blockIdx.x;
  while (k >= n_blocks - bi) {
    k -= n_blocks - bi;
    ++bi;
  }
  const int row0 = bi * kBM, col0 = (bi + k) * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
  block_mma(acc, a + (long long)row0 * ld, a + (long long)col0 * ld, ld, As,
            Bs);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gr = row0 + wm * kWM + mt * 16 + g + ((i >> 1) << 3);
        const int gc = col0 + wn * kWN + nt * 8 + t * 2 + (i & 1);
        c[(long long)gr * ldc + gc] += acc[mt][nt][i];
      }
}

Weights load_weights(const void* weights_host, int P) {
  Weights w;
  for (int p = 0; p < kMaxPlanes; ++p)
    w.w[p] = p < P ? static_cast<const float*>(weights_host)[p] : 0.f;
  return w;
}

}  // namespace

// planes_*: (P, N*, d_pad) int8 with plane strides stride_*; thr_*: float32
// squared-norm thresholds; coords: (n_tiles, 2) int32 tile indices (units
// of tile_r rows / tile_c columns); weights_host: P float32 on the HOST.
// counts: (n_tiles,) int32, zeroed by the caller. APPEND also takes rc:
// (cap, 2) int32 and total: one uint32, zeroed by the caller. mask_self
// drops the pairs whose row index equals column index + diag_offset: 0 when
// both operands share one row numbering, the column operand's first global
// row minus the row operand's when they are two windows of one database.
MVS_EXPORT int mvs_sweep(const void* planes_i, const void* planes_j,
                         const void* thr_i, const void* thr_j, int P, int d,
                         int d_pad, long long stride_i, long long stride_j,
                         const void* coords, int n_tiles, int tile_r,
                         int tile_c, const void* weights_host,
                         float slack_rel, float slack_abs, int mask_self,
                         long long diag_offset, int append, void* counts,
                         void* rc, void* total,
                         long long cap, void* stream) {
  if (P < 1 || P > kMaxPlanes || tile_r <= 0 || tile_c <= 0 ||
      tile_r % kBM || tile_c % kBN || d_pad % kBK || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  const long long grid =
      (long long)n_tiles * (tile_r / kBM) * (tile_c / kBN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  if (grid == 0) return mvs_launch_status();
  Args a{};
  a.planes_i = (const int8_t*)planes_i;
  a.planes_j = (const int8_t*)planes_j;
  a.thr_i = (const float*)thr_i;
  a.thr_j = (const float*)thr_j;
  a.P = P;
  a.dval = (float)d;
  a.d_pad = d_pad;
  a.stride_i = stride_i;
  a.stride_j = stride_j;
  a.coords = (const int32_t*)coords;
  a.tile_r = tile_r;
  a.tile_c = tile_c;
  a.slack_rel = slack_rel;
  a.slack_abs = slack_abs;
  a.mask_self = mask_self;
  a.diag_offset = diag_offset;
  a.counts = (int32_t*)counts;
  a.rc = (int32_t*)rc;
  a.total = (unsigned*)total;
  a.cap = cap;
  const Weights w = load_weights(weights_host, P);
  auto s = (cudaStream_t)stream;
  if (append)
    sweep_kernel<kAppend><<<(unsigned)grid, kThreads, 0, s>>>(a, w);
  else
    sweep_kernel<kCount><<<(unsigned)grid, kThreads, 0, s>>>(a, w);
  return mvs_launch_status();
}

// The SCORE epilogue. q_planes: (P, rows, d_pad) int8 query planes (plane
// stride stride_q); db_planes: (P, >= cols, d_pad) int8, one chunk of the
// stack (plane stride stride_db); inv_n: (cols,) float32; scores: (rows,
// ld) float32, ld >= cols. rows and cols are multiples of 128.
MVS_EXPORT int mvs_scan(const void* q_planes, const void* db_planes, int P,
                        int d_pad, long long stride_q, long long stride_db,
                        int rows, int cols, const void* inv_n, int valid,
                        const void* weights_host, void* scores, long long ld,
                        void* stream) {
  if (P < 1 || P > kMaxPlanes || rows <= 0 || cols <= 0 || rows % kBM ||
      cols % kBN || d_pad % kBK || ld < cols)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)(rows / kBM) * (cols / kBN);
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  Args a{};
  a.planes_i = (const int8_t*)q_planes;
  a.planes_j = (const int8_t*)db_planes;
  a.P = P;
  a.d_pad = d_pad;
  a.stride_i = stride_q;
  a.stride_j = stride_db;
  a.tile_r = rows;
  a.tile_c = cols;
  a.inv_n = (const float*)inv_n;
  a.valid = valid;
  a.scores = (float*)scores;
  a.ld = ld;
  const Weights w = load_weights(weights_host, P);
  sweep_kernel<kScore><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, w);
  return mvs_launch_status();
}

// Kernel G. a: (n, ld) int8, row-major, n a multiple of 128 and ld of 64
// (zero rows and columns change no count); c: (n, ldc) int32. Adds a . a^T
// into the blocks of c on and above the block diagonal.
MVS_EXPORT int mvs_gram(const void* a, int n, int ld, void* c, long long ldc,
                        void* stream) {
  if (n <= 0 || ld <= 0 || n % kBM || ld % kBK || ldc < n)
    return (int)cudaErrorInvalidValue;
  const long long nb = n / kBM;
  const long long grid = nb * (nb + 1) / 2;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  gram_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, ld, (int)nb, (int32_t*)c, ldc);
  return mvs_launch_status();
}

MVS_EXPORT const char* mvs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
