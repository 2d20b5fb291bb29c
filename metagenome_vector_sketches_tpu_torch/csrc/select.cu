// Kernel K: exact top-k selection over rows of (float32 score, index) pairs
// or of packed int64 keys, in the tie order of jax.lax.top_k: score
// descending, then the lowest index first.
//
// Replaces the selection of metagenome_vector_sketches_tpu/ann/int_index.py
// _int_scan_pool (:124; its two-stage exact selection over 128-lane block
// maxima and the running top-`pool` merge, :155-227) and of
// ann/flat_index.py _scan_topk (:47; lax.top_k at :85 and :89), and the
// re-selections of the mesh paths (ann/distributed.py, parallel/pairwise.py).
//
// Keys. An element's key is the int64 of ann/select.py::rank_keys: the
// score's bits mapped to an order-preserving int32 in the high word (-0.0
// taken as +0.0) and 2^32 - 1 - index in the low word, so keys order as
// (score desc, index asc). The kernel works on key ^ 2^63 as an unsigned
// integer. Equal keys (lanes that carry the one "no row" index) are ordered
// by their lane (their position in the row), lowest first, as a stable sort
// orders them: (key desc, lane asc) is a strict total order, and the output
// is the first k elements of the row in it, sorted.
//
// What bounds it: one read of the (B, R) scores (4 bytes an element); the
// selection itself touches a few thousand keys a row. The design keeps the
// score matrix to that one read:
//
// 1. select_block_max_kernel (only when kc < R/128 blocks and kc <= kSmallK):
//    one warp per 128-lane block writes the block's largest key,
//    (B, ceil(R/128)) uint64. This is the pass that reads every score.
// 2. select_rows_kernel, one CTA of 512 threads per row:
//    a. two-stage rows: a radix select over the block maxima picks the kc
//       best blocks (ties by block id). No element outside them can be in
//       the top kc: each chosen block's best element beats the best element
//       of any other block in the total order, and so every element there
//       (JAX's exactness argument, ann/int_index.py:155-166, which holds
//       within tie classes because the lane is part of the order).
//    b. a radix select (8-bit digits, most significant first, histograms in
//       shared memory with warp-aggregated atomics, stopping as soon as the
//       cut's digit bin holds exactly the elements still needed) over the
//       candidates: the lanes of the chosen blocks, or every lane of the row
//       when the row has too few blocks for stage 1 to cut anything (kc >=
//       R/128: tiny chunks, the adaptive search's deep levels where kc
//       reaches R). This is a choice by shape, made by the wrapper
//       (ann/select.py::_two_stage), not a fallback.
//    c. an ordered compaction takes every element above the cut and the
//       first elements on it in lane order, then a bitonic sort in shared
//       memory (kc <= kSmallK) or, for larger kc, bitonic-sorted tiles merged
//       pairwise in global scratch (merge path, one CTA, in coalesced chunks
//       staged through shared memory).
//    d. with a running pool, the merge of the sorted pool (best, W0 keys)
//       and the sorted chunk top: each element's place is its rank plus a
//       binary search in the other list (the pool first among equal keys,
//       as in a stable sort of cat([best, chunk top])); the first wm are
//       written with their positions in that concatenation.

#include "common.cuh"

namespace {

constexpr uint64_t kSign = 0x8000000000000000ull;
constexpr int kThreads = 512;     // threads of a row CTA
constexpr int kSmallK = 2048;     // largest k sorted in shared memory
constexpr int kBlock = 128;       // lanes of one stage-1 block
constexpr int kMaxThreads = 256;  // threads of a block-max CTA

struct Source {
  const float* scores;     // (rows, width) scores, row stride ld; or null
  const int64_t* keys;     // (rows, width) int64 keys, row stride ld; or null
  long long ld;
  int width;
  long long base, valid, none;  // lane l < valid is index base + l, else none
};

__device__ __forceinline__ uint64_t order_key(float s, long long index) {
  int b = __float_as_int(__fadd_rn(s, 0.0f));  // -0.0 -> +0.0
  int f = b ^ ((b >> 31) & 0x7fffffff);
  long long key = (long long)f * 4294967296LL + (4294967295LL - index);
  return (uint64_t)key ^ kSign;
}

__device__ __forceinline__ uint64_t src_key(const Source& s, int row,
                                            int lane) {
  long long at = (long long)row * s.ld + lane;
  if (s.keys != nullptr) return (uint64_t)s.keys[at] ^ kSign;
  return order_key(s.scores[at], lane < s.valid ? s.base + lane : s.none);
}

__device__ __forceinline__ bool better(uint64_t ka, uint32_t la, uint64_t kb,
                                       uint32_t lb) {
  return ka > kb || (ka == kb && la < lb);
}

// The candidates of one row: every lane of the source (kLanes), the block
// maxima of stage 1 (kBlocks; the lane is the block id), or the lanes of
// the chosen blocks (kChosen; candidate i is lane chosen[i / 128] * 128 +
// i % 128). Candidate order is lane order in each mode.
enum Mode { kLanes, kBlocks, kChosen };

struct Cands {
  const Source* src;
  int row;
  const uint64_t* bm;      // kBlocks: this row's block maxima
  const uint32_t* chosen;  // kChosen: chosen block ids, ascending
  int n;
  Mode mode;
};

__device__ __forceinline__ bool cand(const Cands& c, int i, uint64_t& key,
                                     uint32_t& lane) {
  if (c.mode == kBlocks) {
    key = c.bm[i];
    lane = (uint32_t)i;
    return true;
  }
  int l = c.mode == kChosen ? (int)c.chosen[i / kBlock] * kBlock + i % kBlock
                            : i;
  if (l >= c.src->width) return false;
  key = src_key(*c.src, c.row, l);
  lane = (uint32_t)l;
  return true;
}

// Block-wide exclusive prefix sum of v; *total gets the sum over the block.
__device__ int block_excl_scan(int v, int* scan, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) scan[lane] = w;
  }
  __syncthreads();
  int before = warp ? scan[warp - 1] : 0;
  *total = scan[nw - 1];
  __syncthreads();  // scan is reused by the next call
  return before + x - v;
}

// The cut of the top k candidates (1 <= k <= valid candidates): every
// candidate with (key & mask) > pre is taken, and of those with (key & mask)
// == pre the first `need` in candidate order.
struct Cut {
  uint64_t pre, mask;
  int need;
};

__device__ Cut radix_cut(const Cands& c, int k, unsigned* hist, int* scan,
                         int* pick) {
  uint64_t pre = 0, mask = 0;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < c.n; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      uint64_t key = 0;
      uint32_t lane;
      bool ok = i < c.n && cand(c, i, key, lane) && (key & mask) == pre;
      unsigned d = ok ? (unsigned)(key >> shift) & 255u : 256u;
      unsigned peers = __match_any_sync(kFullMask, d);
      if (d < 256u && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&hist[d], (unsigned)__popc(peers));
    }
    __syncthreads();
    // the digit whose bin holds the need-th best candidate: bins from the
    // top (255) down, as an inclusive scan over 256 threads
    unsigned v = 0, x = 0;
    if (threadIdx.x < 256) {
      v = hist[255 - threadIdx.x];
      x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        unsigned y = __shfl_up_sync(kFullMask, x, o);
        if ((threadIdx.x & 31) >= o) x += y;
      }
      if ((threadIdx.x & 31) == 31) scan[threadIdx.x >> 5] = (int)x;
    }
    __syncthreads();
    if (threadIdx.x < 256) {
      unsigned before = 0;
      for (int w = 0; w < (int)(threadIdx.x >> 5); ++w)
        before += (unsigned)scan[w];
      unsigned incl = x + before, excl = incl - v;
      if (excl < (unsigned)need && (unsigned)need <= incl) {
        pick[0] = 255 - (int)threadIdx.x;
        pick[1] = (int)excl;
      }
    }
    __syncthreads();
    const int d = pick[0];
    need -= pick[1];
    pre |= (uint64_t)d << shift;
    mask |= 255ull << shift;
    const bool all = (int)hist[d] == need;  // every one of this bin is taken
    __syncthreads();
    if (all) break;
  }
  return {pre, mask, need};
}

// Writes the k taken candidates of the cut in candidate order (key may be
// null: only the lanes are wanted).
__device__ void collect(const Cands& c, const Cut& cut, int k,
                        uint64_t* key_out, uint32_t* lane_out, int* scan) {
  int taken = 0, eq_seen = 0;
  for (int i0 = 0; i0 < c.n && taken < k; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    uint64_t key = 0;
    uint32_t lane = 0;
    const bool ok = i < c.n && cand(c, i, key, lane);
    const uint64_t p = key & cut.mask;
    const bool gt = ok && p > cut.pre, eq = ok && p == cut.pre;
    int eq_total, t_total;
    const int eq_rank = eq_seen + block_excl_scan(eq, scan, &eq_total);
    const bool take = gt || (eq && eq_rank < cut.need);
    const int slot = taken + block_excl_scan(take, scan, &t_total);
    if (take) {
      if (key_out != nullptr) key_out[slot] = key;
      lane_out[slot] = lane;
    }
    eq_seen += eq_total;
    taken += t_total;
  }
}

// Sorts n2 (a power of two) elements in shared memory, best first.
__device__ void bitonic_desc(uint64_t* key, uint32_t* lane, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const uint64_t ka = key[lo], kb = key[hi];
        const uint32_t la = lane[lo], lb = lane[hi];
        const bool swap = (lo & size) == 0 ? better(kb, lb, ka, la)
                                           : better(ka, la, kb, lb);
        if (swap) {
          key[lo] = kb;
          key[hi] = ka;
          lane[lo] = lb;
          lane[hi] = la;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Loads n elements (padded to a power of two with elements that lose to
// every real one) into shared memory and sorts them there.
__device__ void sort_shared(const uint64_t* key, const uint32_t* lane, int n,
                            uint64_t* s_key, uint32_t* s_lane) {
  const int n2 = pow2_ceil(n);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) {
    s_key[i] = i < n ? key[i] : 0;
    s_lane[i] = i < n ? lane[i] : 0xffffffffu;
  }
  __syncthreads();
  bitonic_desc(s_key, s_lane, n2);
}

// The merge path's split: how many of the first d outputs of merging the
// sorted runs a (la) and b (lb) come from a.
__device__ __forceinline__ int merge_split(const uint64_t* ak,
                                           const uint32_t* al, int la,
                                           const uint64_t* bk,
                                           const uint32_t* bl, int lb,
                                           int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(ak[mid], al[mid], bk[d - 1 - mid], bl[d - 1 - mid]))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One round of sort_global: the sorted runs of w elements of (key, lane)
// merged pairwise into (key2, lane2). The output is cut into chunks of
// kSmallK (w is a multiple of it, so a chunk lies in one pair of runs).
// The CTA finds every chunk's start in its two runs at once (one binary
// search a thread), then for each chunk reads its inputs into shared
// memory with coalesced loads, merges them there (kMergeE outputs a
// thread) and stores them coalesced: scattered global reads, one sector
// an element for each of 100k+ threads, ran far below the HBM rate.
constexpr int kMergeE = kSmallK / kThreads;

__device__ void merge_round(const uint64_t* key, const uint32_t* lane,
                            uint64_t* key2, uint32_t* lane2, int k, int w,
                            uint64_t* s_key, uint32_t* s_lane,
                            int* s_split) {
  const int n_chunks = (k + kSmallK - 1) / kSmallK;
  for (int c0 = 0; c0 < n_chunks; c0 += blockDim.x) {
    for (int t = threadIdx.x; t <= (int)blockDim.x; t += blockDim.x) {
      const int c = c0 + t;
      if (c < n_chunks) {
        const int s = c * kSmallK, ps = s / (2 * w) * (2 * w);
        const int la = min(w, k - ps), lb = max(0, min(w, k - ps - la));
        s_split[t] = merge_split(key + ps, lane + ps, la, key + ps + la,
                                 lane + ps + la, lb, s - ps);
      }
    }
    __syncthreads();
    const int c1 = min(n_chunks, c0 + (int)blockDim.x);
    for (int c = c0; c < c1; ++c) {
      const int s = c * kSmallK, ps = s / (2 * w) * (2 * w);
      const int la = min(w, k - ps), lb = max(0, min(w, k - ps - la));
      const int d0 = s - ps, d1 = min(d0 + kSmallK, la + lb);
      const int a0 = s_split[c - c0];
      // a chunk that does not end its pair is followed by one in the pair
      const int a1 = d1 == la + lb ? la : s_split[c + 1 - c0];
      const int n = d1 - d0, na = a1 - a0, b0 = d0 - a0;
      const uint64_t* ak = key + ps + a0;
      const uint32_t* al = lane + ps + a0;
      const uint64_t* bk = key + ps + la + b0;
      const uint32_t* bl = lane + ps + la + b0;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_key[i] = i < na ? ak[i] : bk[i - na];
        s_lane[i] = i < na ? al[i] : bl[i - na];
      }
      __syncthreads();
      const int e0 = min(n, (int)threadIdx.x * kMergeE);
      int a = merge_split(s_key, s_lane, na, s_key + na, s_lane + na, n - na,
                          e0);
      int b = e0 - a;
      uint64_t ok[kMergeE];
      uint32_t ol[kMergeE];
#pragma unroll
      for (int j = 0; j < kMergeE; ++j) {
        if (e0 + j >= n) break;
        const bool from_a =
            b >= n - na ||
            (a < na && better(s_key[a], s_lane[a], s_key[na + b],
                              s_lane[na + b]));
        const int at = from_a ? a++ : na + b++;
        ok[j] = s_key[at];
        ol[j] = s_lane[at];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMergeE; ++j) {
        if (e0 + j >= n) break;
        s_key[e0 + j] = ok[j];
        s_lane[e0 + j] = ol[j];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        key2[s + i] = s_key[i];
        lane2[s + i] = s_lane[i];
      }
      __syncthreads();
    }
  }
}

// Sorts k elements held in global scratch (key, lane); the second buffer
// (key2, lane2) takes the other half of each merge round. On return key /
// lane point at the sorted elements.
__device__ void sort_global(uint64_t*& key, uint32_t*& lane, uint64_t* key2,
                            uint32_t* lane2, int k, uint64_t* s_key,
                            uint32_t* s_lane, int* s_split) {
  for (int t0 = 0; t0 < k; t0 += kSmallK) {
    const int m = min(kSmallK, k - t0);
    sort_shared(key + t0, lane + t0, m, s_key, s_lane);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      key[t0 + i] = s_key[i];
      lane[t0 + i] = s_lane[i];
    }
    __syncthreads();
  }
  for (int w = kSmallK; w < k; w *= 2) {
    merge_round(key, lane, key2, lane2, k, w, s_key, s_lane, s_split);
    uint64_t* tk = key;
    key = key2;
    key2 = tk;
    uint32_t* tl = lane;
    lane = lane2;
    lane2 = tl;
  }
}

// Number of leading keys of a descending list (n) that are >= x (or > x
// when strict); at(i) gives key i as an unsigned order key.
template <class At>
__device__ __forceinline__ int leading(At at, int n, uint64_t x,
                                       bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint64_t v = at(mid);
    if (strict ? v > x : v >= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kMaxThreads) select_block_max_kernel(
    Source src, int nb, int tiles, uint64_t* bm) {
  const int row = blockIdx.x / tiles;
  const int blk = (blockIdx.x % tiles) * (kMaxThreads / 32) +
                  (threadIdx.x >> 5);
  if (blk >= nb) return;
  const int lane = threadIdx.x & 31;
  uint64_t m = 0;
  uint64_t k[kBlock / 32];
#pragma unroll
  for (int i = 0; i < kBlock / 32; ++i) {
    const int l = blk * kBlock + lane + 32 * i;
    k[i] = l < src.width ? src_key(src, row, l) : 0;
  }
#pragma unroll
  for (int i = 0; i < kBlock / 32; ++i) m = k[i] > m ? k[i] : m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t x = __shfl_xor_sync(kFullMask, m, o);
    m = x > m ? x : m;
  }
  if (lane == 0) bm[(long long)row * nb + blk] = m;
}

__global__ void __launch_bounds__(kThreads) select_rows_kernel(
    Source src, int kc, const uint64_t* bm, int nb, uint64_t* scratch_key,
    uint32_t* scratch_lane, int64_t* out_key, int64_t* out_lane,
    const int64_t* best, int w0, int wm, int64_t* m_key, int64_t* m_pos) {
  __shared__ uint64_t s_key[kSmallK];
  __shared__ uint32_t s_lane[kSmallK];
  __shared__ uint32_t s_chosen[kSmallK];
  __shared__ unsigned s_hist[256];
  __shared__ int s_scan[32];
  __shared__ int s_pick[2];
  __shared__ int s_split[kThreads + 1];
  const int row = blockIdx.x;

  Cands c{&src, row, nullptr, nullptr, src.width, kLanes};
  if (bm != nullptr) {  // stage 1: the kc best blocks, in block order
    const Cands blocks{&src, row, bm + (long long)row * nb, nullptr, nb,
                       kBlocks};
    const Cut cut = radix_cut(blocks, kc, s_hist, s_scan, s_pick);
    collect(blocks, cut, kc, nullptr, s_chosen, s_scan);
    __syncthreads();
    c = Cands{&src, row, nullptr, s_chosen, kc * kBlock, kChosen};
  }
  const Cut cut = radix_cut(c, kc, s_hist, s_scan, s_pick);
  uint64_t* key;
  uint32_t* lane;
  if (kc <= kSmallK) {
    collect(c, cut, kc, s_key, s_lane, s_scan);
    __syncthreads();
    const int n2 = pow2_ceil(kc);
    for (int i = kc + threadIdx.x; i < n2; i += blockDim.x) {
      s_key[i] = 0;
      s_lane[i] = 0xffffffffu;
    }
    __syncthreads();
    bitonic_desc(s_key, s_lane, n2);
    key = s_key;
    lane = s_lane;
  } else {
    key = scratch_key + (long long)row * 2 * kc;
    lane = scratch_lane + (long long)row * 2 * kc;
    collect(c, cut, kc, key, lane, s_scan);
    __syncthreads();
    sort_global(key, lane, key + kc, lane + kc, kc, s_key, s_lane, s_split);
    // sort_global may have swapped the halves
  }
  const long long o = (long long)row * kc;
  for (int i = threadIdx.x; i < kc; i += blockDim.x) {
    out_key[o + i] = (int64_t)(key[i] ^ kSign);
    out_lane[o + i] = (int64_t)lane[i];
  }
  if (wm == 0) return;
  // the running pool's merge: positions in cat([best, chunk top])
  const int64_t* brow = best + (long long)row * w0;
  const long long mo = (long long)row * wm;
  const auto best_at = [brow](int i) { return (uint64_t)brow[i] ^ kSign; };
  const auto top_at = [key](int i) { return key[i]; };
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    const int p = j + leading(best_at, w0, key[j], false);
    if (p < wm) {
      m_key[mo + p] = (int64_t)(key[j] ^ kSign);
      m_pos[mo + p] = w0 + j;
    }
  }
  for (int i = threadIdx.x; i < w0; i += blockDim.x) {
    const uint64_t x = best_at(i);
    const int p = i + leading(top_at, kc, x, true);
    if (p < wm) {
      m_key[mo + p] = brow[i];
      m_pos[mo + p] = i;
    }
  }
}

}  // namespace

// scores (float32) or keys (int64): (rows, width) with row stride ld, one
// of them null. Lane l < valid carries the index base + l, any other lane
// the index none (scores only). kc in [1, width]. bm: (rows, ceil(width /
// 128)) uint64 scratch, non-null exactly for the two-stage selection (kc <
// ceil(width / 128) and kc <= 2048); scratch_key / scratch_lane: (rows, 2,
// kc) uint64 / uint32 when kc > 2048, else null. out_key / out_lane: (rows,
// kc) int64. best: (rows, w0) int64 keys sorted descending (the previous
// merge's output); wm = 0 skips the merge, else m_key / m_pos (rows, wm)
// int64 with wm <= w0 + kc.
MVS_EXPORT int mvs_select(const void* scores, const void* keys, long long ld,
                          int rows, int width, long long base,
                          long long valid, long long none, int kc,
                          void* bm, void* scratch_key, void* scratch_lane,
                          void* out_key, void* out_lane, const void* best,
                          int w0, int wm, void* m_key, void* m_pos,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Source src{(const float*)scores, (const int64_t*)keys, ld, width,
                   base, valid, none};
  const int nb = (width + kBlock - 1) / kBlock;
  if (bm != nullptr) {
    const int tiles = (nb + kMaxThreads / 32 - 1) / (kMaxThreads / 32);
    select_block_max_kernel<<<rows * tiles, kMaxThreads, 0, s>>>(
        src, nb, tiles, (uint64_t*)bm);
    int err = mvs_launch_status();
    if (err != 0) return err;
  }
  select_rows_kernel<<<rows, kThreads, 0, s>>>(
      src, kc, (const uint64_t*)bm, nb, (uint64_t*)scratch_key,
      (uint32_t*)scratch_lane, (int64_t*)out_key, (int64_t*)out_lane,
      (const int64_t*)best, w0, wm, (int64_t*)m_key, (int64_t*)m_pos);
  return mvs_launch_status();
}
