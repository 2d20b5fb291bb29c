// Kernel X: exact limb-pair partial dots of candidate pairs.
//
// Replaces: metagenome_vector_sketches_tpu/ops/pairwise.py:888
// plane_partial_dots and the partials stage of sweep_extract_fused_ij
// (:767-782). Both are XLA programs; on the TPU the fused engine computed
// the partials per tile, in the same program as the sweep.
//
// Also the partials of the int8 ANN engine's pooled (query, db row) pairs
// (ann/int_index.py:124 _int_scan_pool carried per-plane partials through
// its top-k instead): rows then index one tensor (the query planes) and
// columns another (one chunk of the database stack).
//
// Math: for a candidate (r, c), D_ab = dot(limb_a(X_r), limb_b(Y_c)) over
// the L balanced int8 limbs (X = Y for the pairwise engine); output the L
// diagonal terms D_aa, then the symmetrised cross terms D_ab + D_ba for
// a < b — the order
// ops/pairwise_math.combine_plane_partials turns into the exact int64 dot.
// Each term is int32-exact (|D| <= d * 128^2, |D_ab + D_ba| <= 2^25 at
// d = 2048).
//
// What bounds it on Hopper: the latency of scattered row reads. Each
// candidate reads 2 L d_pad bytes of limb rows (64-byte aligned rows that
// repeat across candidates and mostly sit in L2) for L^2 d_pad / 4 dp4a;
// the pairs share no operand, so no tensor-core tile fits (an mma tile
// would waste 7/8 of its rows).
//
// Design: a sub-warp of 16 lanes per candidate, 2 candidates per warp, and
// a grid sized to the SMs (as many CTAs as stay resident; each sub-warp
// walks the candidates with the grid's stride, so output row i stays
// rc[i]'s). Per step a lane loads 16 bytes of each of the 2L limb rows
// with ld.global.nc, U steps unrolled (U = 4, 2, 1 for L = 1, 2, >= 3) so
// that 2 L U 16-byte loads are in flight per lane before the first
// __dp4a; at d_pad = 2048 a lane makes 8 steps and the sub-warp reduces
// each accumulator in 4 shuffle levels (5 with one candidate per warp).
// L is a template parameter so the L^2 accumulators stay in registers.
// Chosen on an H100 against 8 and 32 lanes, a grid of one candidate per
// sub-warp and U = 4 (PERF.md): 8 lanes read
// each 2 KB row in 128-byte pieces spread over time and lost 8% on the
// ANN shape's HBM rows; 16 lanes were best at both shapes, and the grid
// sized to the SMs timed the same as one candidate per sub-warp.
//
// Range check without a host round trip: a candidate outside
// [0, nx) x [0, ny) is counted into *bad (device int32) and writes
// nothing; the caller reads the count where it synchronises anyway
// (ops/pairwise.py check_range_flag).
//
// Retention epilogue (mvs_keep, the fused engine's path): the same core,
// then lane 0 of each sub-warp combines the partials into the exact int64
// dot, applies the shard's range filter and the reference's exact
// retention test (int32: C++ truncating int64 division; int16: double
// division; both against 0.05 * (ns_i + ns_j) in float64, every step with
// a rounding intrinsic, so no FMA contraction separates it from numpy's
// answer), and, for the resident engine's triangle grid, the mirror twin
// (c, r) of a candidate whose transposed tile was not swept. It replaces
// the host's combine, exact filter and mirror selection
// (matrix/compute.py; in the JAX package the host's finalize_dots and
// _mirror_mask, metagenome_vector_sketches_tpu/matrix/compute.py:881-912
// and :468-490, on the fused engine's candidates), which read
// every candidate's partials through a pageable device->host copy (20 B a
// candidate at L = 2, 32 B at L = 3) to keep 0.02-0.7% of them. Fused
// into kernel X because the test needs the exact dot and nothing else:
// the core's reduction leaves it in lane 0's registers, so a kept pair
// costs 16 B of output and a dropped one nothing. What bounds it is the
// core's (the scattered row reads); the epilogue adds two 8-byte norm
// reads and O(L^2) integer and double operations a candidate in one lane.
// Kept pairs (row, column, dot; global rows) are compacted with one warp
// ballot and one atomic a warp; the kept count is exact past the buffer's
// capacity, so the wrapper reruns at the exact size
// (ops/pairwise.py pair_keep). Pairs that pass the range filter (twins
// included) and the out-of-range candidates are counted per thread and
// added once a warp.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // lanes per candidate
constexpr int kMaxLimbs = 5;

// The retention epilogue's operands (mvs_keep); unused by the partials
// epilogue.
struct KeepArgs {
  const double* ns;          // float64 squared norms of global rows [0, total)
  long long row_base;        // global row of xs's first row
  long long col_base;        // global row of ys's first row
  long long begin_row, end_row, total;  // the shard's rows; the db's rows
  long long d;               // the sketch dimension (the test's divisor)
  int int16;                 // 1: double division; 0: truncating division
  long long tile;            // > 0: emit mirror twins on this tile grid
  long long rt0, rt1;        // the shard's row tiles [rt0, rt1)
  longlong2* out;            // kept (row | column << 32, dot) records
  long long cap;             // records out holds
  unsigned long long* counters;  // kept, emitted, out of range
};

// The reference's exact retention of an exact dot (ops/pairwise_math
// exact_filter_int32 / exact_filter_int16 against
// 0.05 * (ns_i + ns_j)), one rounded double operation at a time.
__device__ __forceinline__ bool exact_keep(long long dot, double ni,
                                           double nj, long long d,
                                           int int16) {
  const double thr = __dmul_rn(0.05, __dadd_rn(ni, nj));
  const double q = int16 ? __ddiv_rn(__ll2double_rn(dot), __ll2double_rn(d))
                         : __ll2double_rn(dot / d);  // truncates toward 0
  return q > thr;
}

// kKeep: false writes the partials (out, bad); true runs the retention
// epilogue (keep). The candidate loop is uniform across the warp (its two
// sub-warps take candidates w0 and w0 + 1), so the epilogue's ballot sees
// all 32 lanes.
template <int L, bool kKeep>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const int8_t* __restrict__ xs, long long x_stride,
                const int8_t* __restrict__ ys, long long y_stride, int d_pad,
                long long nx, long long ny, const int32_t* __restrict__ rc,
                long long n, int32_t* __restrict__ out,
                int* __restrict__ bad, KeepArgs keep) {
  constexpr int U = L == 1 ? 4 : (L == 2 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x & (kLanes - 1);
  const unsigned mask = (kLanes == 32 ? kFullMask : (1u << kLanes) - 1u)
                        << (lane & ~(kLanes - 1));
  const long long stride = (long long)gridDim.x * (kThreads / kLanes);
  unsigned long long emitted = 0, outside = 0;  // kKeep: per thread
  for (long long w0 =
           ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31)) / kLanes;
       w0 < n; w0 += stride) {
    const long long w = w0 + lane / kLanes;
    bool live = w < n;                           // uniform in the sub-warp
    long long r = 0, c = 0;
    if (live) {
      r = rc[2 * w];
      c = rc[2 * w + 1];
      if (r < 0 || r >= nx || c < 0 || c >= ny) {
        if (sub == 0) {
          if constexpr (kKeep) ++outside;
          else atomicAdd(bad, 1);
        }
        live = false;
      }
    }
    int D[L][L];
#pragma unroll
    for (int a = 0; a < L; ++a)
#pragma unroll
      for (int b = 0; b < L; ++b) D[a][b] = 0;
    const int8_t* xr = xs + r * d_pad;
    const int8_t* yc = ys + c * d_pad;
    for (int k0 = sub * 16; live && k0 < d_pad; k0 += U * kLanes * 16) {
      int4 x[U][L], y[U][L];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * kLanes * 16;
#pragma unroll
        for (int a = 0; a < L; ++a) {
          x[u][a] = k < d_pad ? __ldg(reinterpret_cast<const int4*>(
                                    xr + a * x_stride + k))
                              : make_int4(0, 0, 0, 0);
          y[u][a] = k < d_pad ? __ldg(reinterpret_cast<const int4*>(
                                    yc + a * y_stride + k))
                              : make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int a = 0; a < L; ++a)
#pragma unroll
          for (int b = 0; b < L; ++b) {
            int s = D[a][b];
            s = __dp4a(x[u][a].x, y[u][b].x, s);
            s = __dp4a(x[u][a].y, y[u][b].y, s);
            s = __dp4a(x[u][a].z, y[u][b].z, s);
            s = __dp4a(x[u][a].w, y[u][b].w, s);
            D[a][b] = s;
          }
    }
#pragma unroll
    for (int a = 0; a < L; ++a)
#pragma unroll
      for (int b = 0; b < L; ++b)
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          D[a][b] += __shfl_xor_sync(mask, D[a][b], off);
    if constexpr (!kKeep) {
      if (live && sub == 0) {
        int32_t* o = out + w * (L * (L + 1) / 2);
#pragma unroll
        for (int a = 0; a < L; ++a) o[a] = D[a][a];
        int idx = L;
#pragma unroll
        for (int a = 0; a < L; ++a)
#pragma unroll
          for (int b = a + 1; b < L; ++b) o[idx++] = D[a][b] + D[b][a];
      }
    } else {
      // the exact dot: 2^(14a) D_aa + 2^(7(a+b)) (D_ab + D_ba), the weights
      // of pairwise_math.combine_plane_partials
      long long dot = 0, gr = 0, gc = 0;
      bool kp0 = false, kp1 = false;    // the pair, its twin: kept
      if (live && sub == 0) {
#pragma unroll
        for (int a = 0; a < L; ++a)
          dot += (long long)D[a][a] * (1LL << (14 * a));
#pragma unroll
        for (int a = 0; a < L; ++a)
#pragma unroll
          for (int b = a + 1; b < L; ++b)
            dot += (long long)(D[a][b] + D[b][a]) * (1LL << (7 * (a + b)));
        gr = r + keep.row_base;
        gc = c + keep.col_base;
        const bool in0 = gr >= keep.begin_row && gr < keep.end_row &&
                         gc < keep.total;
        bool twin = false;
        if (keep.tile > 0) {
          const long long ct = gc / keep.tile;
          twin = ct > gr / keep.tile && ct >= keep.rt0 && ct < keep.rt1;
        }
        const bool in1 = twin && gc >= keep.begin_row && gc < keep.end_row &&
                         gr < keep.total;
        emitted += (unsigned)in0 + (unsigned)in1;
        if (in0 || in1) {               // then gr and gc are both < total
          const bool pass =
              exact_keep(dot, keep.ns[gr], keep.ns[gc], keep.d, keep.int16);
          kp0 = in0 && pass;
          kp1 = in1 && pass;
        }
      }
      const unsigned b0 = __ballot_sync(kFullMask, kp0);
      const unsigned b1 = __ballot_sync(kFullMask, kp1);
      const int kept = __popc(b0) + __popc(b1);
      if (kept) {                       // uniform in the warp
        unsigned long long base = 0;
        if (lane == 0)
          base = atomicAdd(&keep.counters[0], (unsigned long long)kept);
        base = __shfl_sync(kFullMask, base, 0);
        const unsigned below = (1u << lane) - 1u;
        const unsigned long long p0 = base + __popc(b0 & below);
        const unsigned long long p1 = base + __popc(b0) + __popc(b1 & below);
        if (kp0 && p0 < (unsigned long long)keep.cap)
          keep.out[p0] = make_longlong2(
              (long long)(unsigned)gr | ((long long)gc << 32), dot);
        if (kp1 && p1 < (unsigned long long)keep.cap)
          keep.out[p1] = make_longlong2(
              (long long)(unsigned)gc | ((long long)gr << 32), dot);
      }
    }
  }
  if constexpr (kKeep) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      emitted += __shfl_xor_sync(kFullMask, emitted, off);
      outside += __shfl_xor_sync(kFullMask, outside, off);
    }
    if (lane == 0 && emitted) atomicAdd(&keep.counters[1], emitted);
    if (lane == 0 && outside) atomicAdd(&keep.counters[2], outside);
  }
}

// CTAs of partials_kernel<L, kKeep> that stay resident on all SMs at once
// of the current device (mvs_set_device), kept per device and instance:
// two cards of one process may differ in SM count
template <int L, bool kKeep>
int resident_ctas() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int* slot = dev >= 0 && dev < kMaxDevices ? &cache[dev] : nullptr;
  if (slot && *slot) return *slot;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                partials_kernel<L, kKeep>,
                                                kThreads, 0);
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (slot) *slot = n;
  return n;
}

template <int L, bool kKeep>
void launch(const int8_t* x, long long x_stride, const int8_t* y,
            long long y_stride, int d_pad, long long nx, long long ny,
            const int32_t* rc, long long n, int32_t* out, int* bad,
            const KeepArgs& keep, cudaStream_t s) {
  const long long need = (n + kThreads / kLanes - 1) / (kThreads / kLanes);
  const int ctas = resident_ctas<L, kKeep>();
  const unsigned grid = (unsigned)(need < ctas ? need : ctas);
  partials_kernel<L, kKeep><<<grid, kThreads, 0, s>>>(
      x, x_stride, y, y_stride, d_pad, nx, ny, rc, n, out, bad, keep);
}

template <bool kKeep>
void launch_limbs(int L, const int8_t* x, long long x_stride,
                  const int8_t* y, long long y_stride, int d_pad,
                  long long nx, long long ny, const int32_t* rc, long long n,
                  int32_t* out, int* bad, const KeepArgs& keep,
                  cudaStream_t s) {
  switch (L) {
    case 1: launch<1, kKeep>(x, x_stride, y, y_stride, d_pad, nx, ny, rc, n, out, bad, keep, s); break;
    case 2: launch<2, kKeep>(x, x_stride, y, y_stride, d_pad, nx, ny, rc, n, out, bad, keep, s); break;
    case 3: launch<3, kKeep>(x, x_stride, y, y_stride, d_pad, nx, ny, rc, n, out, bad, keep, s); break;
    case 4: launch<4, kKeep>(x, x_stride, y, y_stride, d_pad, nx, ny, rc, n, out, bad, keep, s); break;
    case 5: launch<5, kKeep>(x, x_stride, y, y_stride, d_pad, nx, ny, rc, n, out, bad, keep, s); break;
  }
}

}  // namespace

// xs / ys: the first L planes (limbs) of (P, nx, d_pad) / (P, ny, d_pad)
// int8 tensors with plane strides x_stride / y_stride bytes (the same
// tensor twice for the pairwise engine); rc: (n, 2) int32 (row of xs, row
// of ys) pairs; out: (n, L(L+1)/2) int32; bad: one device int32 that counts
// the candidates outside [0, nx) x [0, ny) (their rows are not written).
MVS_EXPORT int mvs_partials(const void* xs, long long x_stride,
                            const void* ys, long long y_stride, int L,
                            int d_pad, long long nx, long long ny,
                            const void* rc, long long n, void* out, void* bad,
                            void* stream) {
  if (L < 1 || L > kMaxLimbs || d_pad % 16 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return mvs_launch_status();
  launch_limbs<false>(L, (const int8_t*)xs, x_stride, (const int8_t*)ys,
                      y_stride, d_pad, nx, ny, (const int32_t*)rc, n,
                      (int32_t*)out, (int*)bad, KeepArgs{},
                      (cudaStream_t)stream);
  return mvs_launch_status();
}

// The retention epilogue over the same operands: rc's candidates are
// operand-local (global rows row_base + r, col_base + c); ns: (total,)
// float64 squared norms of the global rows; a pair is kept when its global
// row lies in [begin_row, end_row), its column below total and the exact
// test of the db's dtype (int16 != 0: double division) passes; tile > 0
// also emits the twin (c, r) of every candidate whose column tile c / tile
// lies in [rt0, rt1) above its row tile, through the same filter. out:
// (cap, 2) int64 records (row | column << 32, dot), the first min(kept,
// cap) written; counters: three zeroed uint64 (kept, exact past cap; the
// pairs that passed the range filter, twins included; the candidates
// outside [0, nx) x [0, ny), which write nothing).
MVS_EXPORT int mvs_keep(const void* xs, long long x_stride, const void* ys,
                        long long y_stride, int L, int d_pad, long long nx,
                        long long ny, const void* rc, long long n,
                        const void* ns, long long row_base,
                        long long col_base, long long begin_row,
                        long long end_row, long long total, long long d,
                        int int16, long long tile, long long rt0,
                        long long rt1, void* out, long long cap,
                        void* counters, void* stream) {
  if (L < 1 || L > kMaxLimbs || d_pad % 16 || n < 0 || d <= 0 || tile < 0 ||
      cap < 0 || row_base < 0 || col_base < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return mvs_launch_status();
  const KeepArgs keep{(const double*)ns, row_base, col_base, begin_row,
                      end_row, total, d, int16, tile, rt0, rt1,
                      (longlong2*)out, cap, (unsigned long long*)counters};
  launch_limbs<true>(L, (const int8_t*)xs, x_stride, (const int8_t*)ys,
                     y_stride, d_pad, nx, ny, (const int32_t*)rc, n, nullptr,
                     nullptr, keep, (cudaStream_t)stream);
  return mvs_launch_status();
}
