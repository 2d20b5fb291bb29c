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
// sub-warp and U = 4 (compare_kernels.py; PERF.md): 8 lanes read
// each 2 KB row in 128-byte pieces spread over time and lost 8% on the
// ANN shape's HBM rows; 16 lanes were best at both shapes, and the grid
// sized to the SMs timed the same as one candidate per sub-warp.
//
// Range check without a host round trip: a candidate outside
// [0, nx) x [0, ny) is counted into *bad (device int32) and writes
// nothing; the caller reads the count where it synchronises anyway
// (ops/pairwise.py check_range_flag).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // lanes per candidate
constexpr int kMaxLimbs = 5;

template <int L>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const int8_t* __restrict__ xs, long long x_stride,
                const int8_t* __restrict__ ys, long long y_stride, int d_pad,
                long long nx, long long ny, const int32_t* __restrict__ rc,
                long long n, int32_t* __restrict__ out,
                int* __restrict__ bad) {
  constexpr int U = L == 1 ? 4 : (L == 2 ? 2 : 1);
  const int sub = threadIdx.x & (kLanes - 1);
  const unsigned mask = (kLanes == 32 ? kFullMask : (1u << kLanes) - 1u)
                        << (threadIdx.x & 31 & ~(kLanes - 1));
  const long long stride = (long long)gridDim.x * (kThreads / kLanes);
  for (long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
       w < n; w += stride) {
    const long long r = rc[2 * w], c = rc[2 * w + 1];
    if (r < 0 || r >= nx || c < 0 || c >= ny) {  // uniform in the sub-warp
      if (sub == 0) atomicAdd(bad, 1);
      continue;
    }
    const int8_t* xr = xs + r * d_pad;
    const int8_t* yc = ys + c * d_pad;
    int D[L][L];
#pragma unroll
    for (int a = 0; a < L; ++a)
#pragma unroll
      for (int b = 0; b < L; ++b) D[a][b] = 0;
    for (int k0 = sub * 16; k0 < d_pad; k0 += U * kLanes * 16) {
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
    if (sub == 0) {
      int32_t* o = out + w * (L * (L + 1) / 2);
#pragma unroll
      for (int a = 0; a < L; ++a) o[a] = D[a][a];
      int idx = L;
#pragma unroll
      for (int a = 0; a < L; ++a)
#pragma unroll
        for (int b = a + 1; b < L; ++b) o[idx++] = D[a][b] + D[b][a];
    }
  }
}

// CTAs of partials_kernel<L> that stay resident on all SMs at once of the
// current device (mvs_set_device), kept per device and L: two cards of one
// process may differ in SM count
template <int L>
int resident_ctas() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int* slot = dev >= 0 && dev < kMaxDevices ? &cache[dev] : nullptr;
  if (slot && *slot) return *slot;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, partials_kernel<L>,
                                                kThreads, 0);
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (slot) *slot = n;
  return n;
}

template <int L>
void launch(const int8_t* x, long long x_stride, const int8_t* y,
            long long y_stride, int d_pad, long long nx, long long ny,
            const int32_t* rc, long long n, int32_t* out, int* bad,
            cudaStream_t s) {
  const long long need = (n + kThreads / kLanes - 1) / (kThreads / kLanes);
  const unsigned grid = (unsigned)(need < resident_ctas<L>()
                                       ? need : resident_ctas<L>());
  partials_kernel<L><<<grid, kThreads, 0, s>>>(x, x_stride, y, y_stride,
                                               d_pad, nx, ny, rc, n, out, bad);
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
  auto s = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)xs;
  const int8_t* y = (const int8_t*)ys;
  const int32_t* p = (const int32_t*)rc;
  int32_t* o = (int32_t*)out;
  int* f = (int*)bad;
  switch (L) {
    case 1: launch<1>(x, x_stride, y, y_stride, d_pad, nx, ny, p, n, o, f, s); break;
    case 2: launch<2>(x, x_stride, y, y_stride, d_pad, nx, ny, p, n, o, f, s); break;
    case 3: launch<3>(x, x_stride, y, y_stride, d_pad, nx, ny, p, n, o, f, s); break;
    case 4: launch<4>(x, x_stride, y, y_stride, d_pad, nx, ny, p, n, o, f, s); break;
    case 5: launch<5>(x, x_stride, y, y_stride, d_pad, nx, ny, p, n, o, f, s); break;
  }
  return mvs_launch_status();
}
