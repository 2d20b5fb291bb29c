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
// What bounds it on Hopper: memory. Each candidate reads 2 * L * d bytes of
// limb rows (scattered rows, 64-byte aligned) for L^2 * d multiply-adds;
// with survivors a small fraction of all pairs it is a short pass next to
// the sweep.
//
// Design: one warp per candidate. Each lane loads 16 bytes of each of the
// 2L limb rows per step (the warp covers 512 contiguous bytes of a row),
// accumulates the L^2 products with __dp4a, and the warp reduces them with
// shuffles; lane 0 writes the L(L+1)/2 outputs. L is a template parameter
// so the accumulators stay in registers.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLimbs = 5;

template <int L>
__global__ void __launch_bounds__(kThreads)
partials_kernel(const int8_t* __restrict__ xs, long long x_stride,
                const int8_t* __restrict__ ys, long long y_stride, int d_pad,
                const int32_t* __restrict__ rc, long long n,
                int32_t* __restrict__ out) {
  const long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;  // whole warp leaves
  const long long r = rc[2 * w], c = rc[2 * w + 1];
  int D[L][L];
#pragma unroll
  for (int a = 0; a < L; ++a)
#pragma unroll
    for (int b = 0; b < L; ++b) D[a][b] = 0;
  for (int k = lane * 16; k < d_pad; k += 32 * 16) {
    int4 x[L], y[L];
#pragma unroll
    for (int a = 0; a < L; ++a) {
      x[a] = *reinterpret_cast<const int4*>(xs + a * x_stride + r * d_pad + k);
      y[a] = *reinterpret_cast<const int4*>(ys + a * y_stride + c * d_pad + k);
    }
#pragma unroll
    for (int a = 0; a < L; ++a)
#pragma unroll
      for (int b = 0; b < L; ++b) {
        int s = D[a][b];
        s = __dp4a(x[a].x, y[b].x, s);
        s = __dp4a(x[a].y, y[b].y, s);
        s = __dp4a(x[a].z, y[b].z, s);
        s = __dp4a(x[a].w, y[b].w, s);
        D[a][b] = s;
      }
  }
#pragma unroll
  for (int a = 0; a < L; ++a)
#pragma unroll
    for (int b = 0; b < L; ++b)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        D[a][b] += __shfl_xor_sync(kFullMask, D[a][b], off);
  if (lane == 0) {
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

}  // namespace

// xs / ys: the first L planes (limbs) of (P, N*, d_pad) int8 tensors with
// plane strides x_stride / y_stride bytes (the same tensor twice for the
// pairwise engine); rc: (n, 2) int32 (row of xs, row of ys) pairs;
// out: (n, L(L+1)/2) int32.
MVS_EXPORT int mvs_partials(const void* xs, long long x_stride,
                            const void* ys, long long y_stride, int L,
                            int d_pad, const void* rc, long long n, void* out,
                            void* stream) {
  if (L < 1 || L > kMaxLimbs || d_pad % 16 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return mvs_launch_status();
  const long long grid = (n * 32 + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  const int8_t* x = (const int8_t*)xs;
  const int8_t* y = (const int8_t*)ys;
  const int32_t* p = (const int32_t*)rc;
  int32_t* o = (int32_t*)out;
  const unsigned g = (unsigned)grid;
  switch (L) {
    case 1: partials_kernel<1><<<g, kThreads, 0, s>>>(x, x_stride, y, y_stride, d_pad, p, n, o); break;
    case 2: partials_kernel<2><<<g, kThreads, 0, s>>>(x, x_stride, y, y_stride, d_pad, p, n, o); break;
    case 3: partials_kernel<3><<<g, kThreads, 0, s>>>(x, x_stride, y, y_stride, d_pad, p, n, o); break;
    case 4: partials_kernel<4><<<g, kThreads, 0, s>>>(x, x_stride, y, y_stride, d_pad, p, n, o); break;
    case 5: partials_kernel<5><<<g, kThreads, 0, s>>>(x, x_stride, y, y_stride, d_pad, p, n, o); break;
  }
  return mvs_launch_status();
}
