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
// is the first kc elements of the row in it, sorted, then (with a running
// pool) their merge with the pool. The wrapper (ann/select.py::regime)
// picks one of four regimes by shape; every one gives the same outputs.
//
// 1. Two-stage (kc <= 2,048 and kc below the row's 128-lane block count:
//    every search chunk, the mesh pools, adaptive levels 0-3). Bound: one
//    read of the (B, R) scores, 4 bytes an element. One launch
//    (select_chunk_kernel) of B x T CTAs, each over a 32,768-lane tile of a
//    row, keeps four 16-byte loads a lane in flight and reduces four
//    128-lane blocks at once in 32 bits (the flipped scores, a transposed
//    butterfly of 6 shuffles, then a ballot for the lowest lane at the
//    maximum): 64-bit keys a lane made the pass issue-bound. It writes the
//    block maxima as keys (ties between blocks go to the lower block, as to
//    the lower lane), counts itself in a per-row arrival counter
//    (threadfence, atomicAdd), and the row's last CTA runs the row stage
//    while other rows still stream: no second launch, no tail between two
//    kernels. The row stage works in shared memory: the row's block maxima
//    (loaded once), a radix cut for the kc best blocks (skipping the
//    leading bytes all maxima share), T = the smallest of their maxima, one
//    pass over the chosen blocks' lanes with their loads in flight keeping
//    the elements with key >= T (warp-ballot compaction), then the top kc:
//    by rank among at most 256 survivors (no sort), else a bitonic sort.
//    Exact: each chosen block's best element beats the best element of
//    every other block, so the top kc lie in the chosen blocks and have
//    key >= T (JAX's argument, ann/int_index.py:155-166, which holds inside
//    tie classes because the lane is part of the order). More than 2,048
//    survivors (rows of equal scores, all -inf rows: up to kc x 128) take
//    an exact path of the same stage: the radix cut over the chosen blocks'
//    lanes and an ordered compaction. 64 registers, two CTAs an SM: a cap
//    of 40 (three CTAs) spilled in the row stage and ran slower.
// 2. Row (kc <= 2,048 on rows of at most 16,384 lanes, where the block
//    maxima would cut nothing: small re-selections): the same kernel, one
//    CTA a row, the radix cut over every lane of the row.
// 3. Radix (any other kc < width: adaptive levels 4-7). A multi-CTA radix
//    select (AIR top-k, Zhang et al., SC'23) over the 96 bits of (key,
//    ~lane) in 8-bit digits, one launch a digit (select_radix_kernel): B x T
//    CTAs add shared-memory histograms into per-row ones, the row's last CTA
//    picks the digit. The second pass reads the row once more and splits it:
//    elements above the first digit's cut go straight to the taken buffer,
//    those on it to a per-row candidate buffer that later passes read
//    alone; passes of a finished row return at once. select_collect_kernel
//    moves the candidates at or above the final cut (exactly kc taken in
//    all, in no order) and the grid-wide sort below orders them. Bound: two
//    reads of the scores plus the sort of kc elements; the two full passes
//    are held by their shared-memory histogram atomics.
// 4. Full (kc = width: the adaptive search's deepest level, select_keys
//    with k >= W): no selection, the row's lanes go straight to the sort.
//
// The grid-wide sort (regimes 3 and 4): B x ceil(kc / 2,048) CTAs each sort
// a 2,048-element tile (select_sort_kernel: a bitonic network with four
// elements a thread in registers, its strides below 128 in registers and
// warp shuffles, only the larger ten of its 66 stages through shared
// memory), then log2(kc / 2,048) merge rounds: select_split_kernel finds
// every 2,048-element output chunk's start in its pair of runs (one
// thread a chunk, all binary searches in flight at once), then
// select_merge_kernel, a CTA a chunk, stages its inputs through shared
// memory with coalesced loads, merges there and stores coalesced. The last
// round (or the tile sort of a one-tile row) writes the int64 outputs;
// select_pool_kernel merges them with the running pool. Bound: 12 bytes
// read and written an element each round.
//
// The pool merge (every regime): each element's place is its rank plus a
// binary search in the other sorted list (the pool first among equal keys,
// as in a stable sort of cat([best, chunk top])); the first wm are written
// with their positions in that concatenation.

#include "common.cuh"

namespace {

constexpr uint64_t kSign = 0x8000000000000000ull;
constexpr int kThreads = 512;            // threads of every CTA of K
constexpr int kWarps = kThreads / 32;
constexpr int kSmallK = 2048;            // largest kc of a row stage; sort tile
constexpr int kBlock = 128;              // lanes of one stage-1 block
constexpr int kTileBlocks = 256;         // blocks of one CTA's tile
constexpr int kTile = kTileBlocks * kBlock;
constexpr int kPerWarp = kTileBlocks / kWarps;  // blocks of a tile a warp
constexpr int kInFlight = 4;             // 16-byte loads in flight a lane
static_assert(kInFlight == 4, "the block-maximum butterfly reduces four");
constexpr int kSurv = 2048;              // survivors sorted in shared memory
static_assert(kSurv <= 4 * kThreads, "pad_and_sort sorts at most 4 a thread");
constexpr int kBmShared = kSurv * 12 / 8;  // block maxima held there
constexpr int kRank = 256;               // survivors ranked, not sorted
constexpr int kPasses = 12;              // 8-bit digits of (key, ~lane)
constexpr int kMergeE = kSmallK / kThreads;  // merge outputs a thread

enum Regime { kTwoStage = 0, kRow = 1, kRadix = 2, kFull = 3 };

struct Source {
  const float* scores;     // (rows, width) scores, row stride ld; or null
  const int64_t* keys;     // (rows, width) int64 keys, row stride ld; or null
  long long ld;
  int width;
  long long base, valid, none;  // lane l < valid is index base + l, else none
  bool vec;                // rows 16-byte aligned: vector loads
};

// A score's bits as an order-preserving int32 (-0.0 taken as +0.0).
__device__ __forceinline__ int flip_score(float s) {
  const int b = __float_as_int(__fadd_rn(s, 0.0f));
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ uint64_t pack_key(int f, long long index) {
  const long long key = (long long)f * 4294967296LL + (4294967295LL - index);
  return (uint64_t)key ^ kSign;
}

__device__ __forceinline__ uint64_t score_key(const Source& s, float v,
                                              int lane) {
  return pack_key(flip_score(v), lane < s.valid ? s.base + lane : s.none);
}

// A load past the L1 (data another CTA of this launch wrote).
__device__ __forceinline__ uint64_t ldcg64(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint64_t src_key(const Source& s, long long row,
                                            int lane) {
  long long at = row * s.ld + lane;
  if (s.keys != nullptr)
    return (uint64_t)__ldg(reinterpret_cast<const long long*>(s.keys) + at) ^
           kSign;
  return score_key(s, __ldg(s.scores + at), lane);
}

// The keys of the four lanes of 128-lane block `blk` that this warp lane
// holds, and those lanes; lanes past the width get key 0 and a lane >=
// width. Aligned rows and whole blocks take one or two 16-byte loads.
__device__ __forceinline__ void block_keys(const Source& s, long long row,
                                           int blk, uint64_t k[4],
                                           int ln[4]) {
  const int l = threadIdx.x & 31, b0 = blk * kBlock;
  const long long at = row * s.ld + b0;
  if (s.vec && b0 + kBlock <= s.width) {
    if (s.keys != nullptr) {
      const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(
                                    s.keys + at) + l);
      const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(
                                    s.keys + at + kBlock / 2) + l);
      ln[0] = b0 + 2 * l;
      ln[1] = ln[0] + 1;
      ln[2] = ln[0] + kBlock / 2;
      ln[3] = ln[2] + 1;
      k[0] = (uint64_t)a.x ^ kSign;
      k[1] = (uint64_t)a.y ^ kSign;
      k[2] = (uint64_t)b.x ^ kSign;
      k[3] = (uint64_t)b.y ^ kSign;
    } else {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 s.scores + at) + l);
      const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ln[i] = b0 + 4 * l + i;
        k[i] = score_key(s, f[i], ln[i]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ln[i] = b0 + l + 32 * i;
    k[i] = ln[i] < s.width ? src_key(s, row, ln[i]) : 0;
  }
}

__device__ __forceinline__ bool better(uint64_t ka, uint32_t la, uint64_t kb,
                                       uint32_t lb) {
  return ka > kb || (ka == kb && la < lb);
}

// The candidates of one row: every lane of the source (kLanes), the block
// maxima of stage 1 (kBlocks; the lane is the block id; in shared memory,
// or in global memory written by the row's other CTAs, read past the L1),
// or the lanes of the chosen blocks (kChosen; candidate i is lane
// chosen[i / 128] * 128 + i % 128). Candidate order is lane order in each
// mode.
enum Mode { kLanes, kBlocks, kChosen };

struct Cands {
  const Source* src;
  long long row;
  const uint64_t* bm;      // kBlocks: this row's block maxima
  bool bm_global;
  const uint32_t* chosen;  // kChosen: chosen block ids, ascending
  int n;
  Mode mode;
};

__device__ __forceinline__ bool cand(const Cands& c, int i, uint64_t& key,
                                     uint32_t& lane) {
  if (c.mode == kBlocks) {
    key = c.bm_global ? ldcg64(c.bm + i) : c.bm[i];
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

// Adds 1 to hist[d] for every lane of the warp with d < 256: one shared
// atomic for the warp when all its lanes share the digit (the common case
// of the first digits), else one a lane.
__device__ __forceinline__ void warp_hist(unsigned* hist, unsigned d) {
  const unsigned d0 = __shfl_sync(kFullMask, d, 0);
  if (__all_sync(kFullMask, d == d0)) {
    if ((threadIdx.x & 31) == 0 && d0 < 256u) atomicAdd(&hist[d0], 32u);
  } else if (d < 256u) {
    atomicAdd(&hist[d], 1u);
  }
}

// The digit whose bin of hist (256 bins, in shared memory) holds the
// need-th best element, counting bins from the top (255) down: pick[0]
// gets the digit, pick[1] the count in the bins above it. Every thread
// calls it; hist and pick are read after the call's last barrier.
__device__ __forceinline__ void pick_digit(const unsigned* hist, int need,
                                           int* scan, int* pick) {
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
}

// The cut of the top k candidates (1 <= k <= valid candidates): every
// candidate with (key & mask) > pre is taken, and of those with (key & mask)
// == pre the first `need` in candidate order.
struct Cut {
  uint64_t pre, mask;
  int need;
  bool all;  // every candidate on the prefix is taken (need of them)
};

__device__ __forceinline__ Cut radix_cut(const Cands& c, int k,
                                         unsigned* hist, int* scan,
                                         int* pick) {
  // the leading bytes every candidate shares need no pass (block maxima of
  // similar scores share their sign and exponent): OR of key ^ candidate
  // 0's key over the candidates, reduced into hist's first 8 bytes
  uint64_t ref = 0, diff = 0;
  uint32_t unused;
  cand(c, 0, ref, unused);
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(hist);
  if (threadIdx.x == 0) *acc = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < c.n; i += blockDim.x) {
    uint64_t key;
    if (cand(c, i, key, unused)) diff |= key ^ ref;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) diff |= __shfl_xor_sync(kFullMask, diff, o);
  if ((threadIdx.x & 31) == 0 && diff) atomicOr(acc, (unsigned long long)diff);
  __syncthreads();
  diff = *acc;
  __syncthreads();  // hist is cleared next
  const int common = diff ? __clzll((long long)diff) / 8 : 8;
  const int first = 56 - 8 * min(common, 7);
  uint64_t mask = first == 56 ? 0 : ~0ull << (first + 8);
  uint64_t pre = ref & mask;
  int need = k;
  for (int shift = first; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < c.n; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      uint64_t key = 0;
      uint32_t lane;
      bool ok = i < c.n && cand(c, i, key, lane) && (key & mask) == pre;
      warp_hist(hist, ok ? (unsigned)(key >> shift) & 255u : 256u);
    }
    __syncthreads();
    pick_digit(hist, need, scan, pick);
    const int d = pick[0];
    need -= pick[1];
    pre |= (uint64_t)d << shift;
    mask |= 255ull << shift;
    const bool all = (int)hist[d] == need;  // every one of this bin is taken
    __syncthreads();
    if (all) return {pre, mask, need, true};
  }
  return {pre, mask, need, false};
}

// Writes the k taken candidates of the cut in candidate order (key may be
// null: only the lanes are wanted).
__device__ __forceinline__ void collect(const Cands& c, const Cut& cut,
                                        int k, uint64_t* key_out,
                                        uint32_t* lane_out, int* scan) {
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

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Sorts the E * kThreads elements in s_key / s_lane best first with a
// bitonic network, each thread holding E consecutive elements in
// registers: the stages of strides below E run in the thread's registers,
// those below a warp's 32 * E elements across the warp with shuffles, and
// only the larger ones through shared memory (10 of the 66 stages of
// 2,048 elements).
template <int E>
__device__ __forceinline__ void sort_tile(uint64_t* s_key,
                                          uint32_t* s_lane) {
  constexpr int kN = E * kThreads, kWarpSpan = 32 * E;
  const int t = threadIdx.x;
  uint64_t k[E];
  uint32_t ln[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    k[r] = s_key[E * t + r];
    ln[r] = s_lane[E * t + r];
  }
  for (int size = 2; size <= kN; size <<= 1) {
    int j = size >> 1;
    if (j >= kWarpSpan) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        s_key[E * t + r] = k[r];
        s_lane[E * t + r] = ln[r];
      }
      __syncthreads();
      for (; j >= kWarpSpan; j >>= 1) {
        for (int i = t; i < kN / 2; i += blockDim.x) {
          const int lo = 2 * i - (i & (j - 1)), hi = lo + j;
          const uint64_t ka = s_key[lo], kb = s_key[hi];
          const uint32_t la = s_lane[lo], lb = s_lane[hi];
          if ((lo & size) == 0 ? better(kb, lb, ka, la)
                               : better(ka, la, kb, lb)) {
            s_key[lo] = kb;
            s_key[hi] = ka;
            s_lane[lo] = lb;
            s_lane[hi] = la;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < E; ++r) {
        k[r] = s_key[E * t + r];
        ln[r] = s_lane[E * t + r];
      }
    }
    for (; j >= E; j >>= 1) {  // the partner is thread t ^ (j / E)
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int i = E * t + r;
        const uint64_t ok = __shfl_xor_sync(kFullMask, k[r], j / E);
        const uint32_t ol = __shfl_xor_sync(kFullMask, ln[r], j / E);
        // the pair's lower element takes the better one in a block
        // sorted best first
        const bool keep_better = ((i & j) == 0) == ((i & size) == 0);
        if (keep_better != better(k[r], ln[r], ok, ol)) {
          k[r] = ok;
          ln[r] = ol;
        }
      }
    }
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1) {  // strides known at compile time
      if (jj > j) continue;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int p = r ^ jj;
        if (p > r) {
          const bool desc = ((E * t + r) & size) == 0;
          if (desc ? better(k[p], ln[p], k[r], ln[r])
                   : better(k[r], ln[r], k[p], ln[p])) {
            const uint64_t tk = k[r];
            k[r] = k[p];
            k[p] = tk;
            const uint32_t tl = ln[r];
            ln[r] = ln[p];
            ln[p] = tl;
          }
        }
      }
    }
  }
  __syncthreads();  // every thread has read its elements
#pragma unroll
  for (int r = 0; r < E; ++r) {
    s_key[E * t + r] = k[r];
    s_lane[E * t + r] = ln[r];
  }
  __syncthreads();
}

// Pads n (at most kSurv) elements in shared memory to E * kThreads (E a
// power of two) with elements that lose to every real one, then sorts
// them.
__device__ __forceinline__ void pad_and_sort(uint64_t* key, uint32_t* lane,
                                             int n) {
  const int e = pow2_ceil((n + kThreads - 1) / kThreads);
  for (int i = n + threadIdx.x; i < e * kThreads; i += blockDim.x) {
    key[i] = 0;
    lane[i] = 0xffffffffu;
  }
  __syncthreads();
  switch (e) {
    case 1: sort_tile<1>(key, lane); break;
    case 2: sort_tile<2>(key, lane); break;
    default: sort_tile<4>(key, lane); break;
  }
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

// What a row stage or the sort writes: the chunk top (rows, kc) and the
// merge with the running pool best (rows, w0) into (rows, wm).
struct Out {
  int64_t* key;
  int64_t* lane;
  const int64_t* best;
  int kc, w0, wm;
  int64_t* m_key;
  int64_t* m_pos;
};

// Shared memory of select_chunk_kernel (dynamic: above the 48 KB of static
// shared memory).
struct ChunkShared {
  uint64_t key[kSurv];       // the survivors, then the sorted top; before
  uint32_t lane[kSurv];      // them both hold the row's block maxima (bm)
  uint64_t aux[kSmallK];     // chosen block ids (uint32), then the pool
  unsigned hist[256];
  int scan[32];
  int pick[2];
  unsigned long long t;      // the smallest maximum of the chosen blocks
  int count;
  int last;
  __device__ uint64_t* bm() { return key; }
};
static_assert(sizeof(ChunkShared::key) + sizeof(ChunkShared::lane) >=
                  kBmShared * sizeof(uint64_t),
              "the block maxima fit in the survivors' space");

__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t x = __shfl_xor_sync(kFullMask, v, o);
    v = x < v ? x : v;
  }
  return v;
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t x = __shfl_xor_sync(kFullMask, v, o);
    v = x > v ? x : v;
  }
  return v;
}

// Writes one row's sorted top (kc in shared memory) and its merge with
// the running pool (best in shared memory when it fits, else read from
// global memory).
__device__ __forceinline__ void write_row(const Out& o, long long row,
                                          const uint64_t* key,
                                          const uint32_t* lane,
                                          uint64_t* aux) {
  const int kc = o.kc;
  const long long ro = row * kc;
  for (int i = threadIdx.x; i < kc; i += blockDim.x) {
    o.key[ro + i] = (int64_t)(key[i] ^ kSign);
    o.lane[ro + i] = (int64_t)lane[i];
  }
  if (o.wm == 0) return;
  const int64_t* brow = o.best + row * o.w0;
  const bool shared = o.w0 <= kSmallK;
  if (shared) {
    for (int i = threadIdx.x; i < o.w0; i += blockDim.x)
      aux[i] = (uint64_t)brow[i] ^ kSign;
    __syncthreads();
  }
  const long long mo = row * o.wm;
  const auto best_at = [brow, aux, shared](int i) {
    return shared ? aux[i] : (uint64_t)brow[i] ^ kSign;
  };
  const auto top_at = [key](int i) { return key[i]; };
  for (int j = threadIdx.x; j < kc; j += blockDim.x) {
    const int p = j + leading(best_at, o.w0, key[j], false);
    if (p < o.wm) {
      o.m_key[mo + p] = (int64_t)(key[j] ^ kSign);
      o.m_pos[mo + p] = o.w0 + j;
    }
  }
  for (int i = threadIdx.x; i < o.w0; i += blockDim.x) {
    const uint64_t x = best_at(i);
    const int p = i + leading(top_at, kc, x, true);
    if (p < o.wm) {
      o.m_key[mo + p] = brow[i];
      o.m_pos[mo + p] = i;
    }
  }
}

// Stage 1 of the two-stage regime: tile `tile` of row `row` (kTileBlocks
// blocks; this warp's are blk0 + j * kWarps) into the block maxima bm. In
// a tile of whole blocks of aligned scores each lane keeps kInFlight
// 16-byte loads in flight and the warp reduces their four blocks at once.
__device__ __forceinline__ void tile_maxima(const Source& src, long long row,
                                            int tile, int nb, uint64_t* bm) {
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int blk0 = tile * kTileBlocks + warp;
  if (src.scores != nullptr && src.vec && (tile + 1) * kTile <= src.width) {
    const float4* p = reinterpret_cast<const float4*>(
                          src.scores + row * src.ld + blk0 * kBlock) + l;
    for (int g = 0; g < kPerWarp; g += kInFlight) {
      float4 v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j)
        v[j] = __ldg(p + (g + j) * kWarps * kBlock / 4);
      // the four blocks' largest flipped scores, reduced across the warp
      // together in 32 bits (a transposed butterfly: lanes 0-15 keep
      // blocks 0 and 1, then lanes 0-7 block 0, ...): lane 8j ends with
      // block j's maximum
      int f[kInFlight][4], m[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        f[j][0] = flip_score(v[j].x);
        f[j][1] = flip_score(v[j].y);
        f[j][2] = flip_score(v[j].z);
        f[j][3] = flip_score(v[j].w);
        m[j] = max(max(f[j][0], f[j][1]), max(f[j][2], f[j][3]));
      }
      const bool h16 = l & 16, h8 = l & 8;
      int a0 = h16 ? m[2] : m[0], a1 = h16 ? m[3] : m[1];
      a0 = max(a0, __shfl_xor_sync(kFullMask, h16 ? m[0] : m[2], 16));
      a1 = max(a1, __shfl_xor_sync(kFullMask, h16 ? m[1] : m[3], 16));
      int r = h8 ? a1 : a0;
      r = max(r, __shfl_xor_sync(kFullMask, h8 ? a0 : a1, 8));
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        r = max(r, __shfl_xor_sync(kFullMask, r, o));
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int blk = blk0 + (g + j) * kWarps;
        const long long b0 = (long long)blk * kBlock;
        if (b0 < src.valid && b0 + kBlock > src.valid) {
          // indices change from base + lane to none inside the block: the
          // keys themselves (warp-uniform branch)
          uint64_t k = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int lane = (int)b0 + 4 * l + i;
            const uint64_t x = pack_key(
                f[j][i], lane < src.valid ? src.base + lane : src.none);
            k = x > k ? x : k;
          }
          k = warp_max(k);
          if (l == j) bm[row * nb + blk] = k;
          continue;
        }
        // every lane of the block carries base + lane, or every one none:
        // the best key is at the block's maximum, lowest lane first
        const int top = __shfl_sync(kFullMask, r, 8 * j);
        int first = 4;
#pragma unroll
        for (int i = 3; i >= 0; --i)
          if (f[j][i] == top) first = i;
        const unsigned bal = __ballot_sync(kFullMask, first < 4);
        const int at = __ffs(bal) - 1;
        const int lane = (int)b0 + 4 * at + __shfl_sync(kFullMask, first, at);
        if (l == j)
          bm[row * nb + blk] =
              pack_key(top, lane < src.valid ? src.base + lane : src.none);
      }
    }
  } else {
    for (int j = 0; j < kPerWarp; ++j) {
      const int blk = blk0 + j * kWarps;
      if (blk >= nb) break;  // warp-uniform
      uint64_t k[4];
      int ln[4];
      block_keys(src, row, blk, k, ln);
      uint64_t m = k[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) m = k[i] > m ? k[i] : m;
      m = warp_max(m);
      if (l == j % kInFlight) bm[row * nb + blk] = m;
    }
  }
}

// The row stage of the two-stage regime, run by the CTA that wrote the
// row's last block maxima: the kc best blocks, their survivors, the
// chunk top and its merge with the running pool.
__device__ __forceinline__ void row_stage(const Source& src, long long row,
                                          int nb, const uint64_t* bm,
                                          const Out& o, ChunkShared& sh) {
  const int kc = o.kc;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  uint32_t* chosen = reinterpret_cast<uint32_t*>(sh.aux);
  const uint64_t* brow = bm + row * nb;
  const bool bm_shared = nb <= kBmShared;
  if (bm_shared) {
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      sh.bm()[i] = ldcg64(brow + i);
    __syncthreads();
  }
  const Cands blocks{&src, row, bm_shared ? sh.bm() : brow, !bm_shared,
                     nullptr, nb, kBlocks};
  const Cut bcut = radix_cut(blocks, kc, sh.hist, sh.scan, sh.pick);
  if (threadIdx.x == 0) {
    sh.t = ~0ull;
    sh.count = 0;
  }
  __syncthreads();
  // the chosen blocks and T, the smallest of their maxima. When the cut
  // takes every block on its prefix (no two blocks tie at the kc-th
  // maximum), they are the blocks at or above it, in any order; else the
  // ordered compaction takes the first ones on it
  const bool ordered = !bcut.all;
  uint64_t t = ~0ull;
  if (ordered) {
    collect(blocks, bcut, kc, nullptr, chosen, sh.scan);
    __syncthreads();
    for (int i = threadIdx.x; i < kc; i += blockDim.x) {
      uint64_t x;
      uint32_t unused;
      cand(blocks, (int)chosen[i], x, unused);
      t = x < t ? x : t;
    }
  } else {
    for (int i0 = 0; i0 < nb; i0 += blockDim.x) {  // block-uniform
      const int i = i0 + threadIdx.x;
      uint64_t x = 0;
      uint32_t unused;
      const bool take = i < nb && cand(blocks, i, x, unused) &&
                        (x & bcut.mask) >= bcut.pre;
      if (take) t = x < t ? x : t;
      const unsigned bal = __ballot_sync(kFullMask, take);
      int at = 0;
      if (l == 0 && bal) at = atomicAdd(&sh.count, __popc(bal));
      at = __shfl_sync(kFullMask, at, 0);
      if (take) chosen[at + __popc(bal & ((1u << l) - 1u))] = (uint32_t)i;
    }
  }
  t = warp_min(t);
  if (l == 0) atomicMin(&sh.t, (unsigned long long)t);
  __syncthreads();
  t = sh.t;
  if (threadIdx.x == 0) sh.count = 0;
  __syncthreads();

  // the survivors: lanes of the chosen blocks with key >= t, each warp
  // with the loads of kInFlight blocks in flight (aligned scores)
  const auto keep = [&sh, t, &src, l](const uint64_t kk[4], const int ll[4]) {
    unsigned bal[4];
    int total = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bal[q] = __ballot_sync(kFullMask, ll[q] < src.width && kk[q] >= t);
      total += __popc(bal[q]);
    }
    int at = 0;
    if (l == 0 && total) at = atomicAdd(&sh.count, total);
    at = __shfl_sync(kFullMask, at, 0);
    const unsigned below = (1u << l) - 1u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if ((bal[q] >> l) & 1u) {
        const int slot = at + __popc(bal[q] & below);
        if (slot < kSurv) {
          sh.key[slot] = kk[q];
          sh.lane[slot] = (uint32_t)ll[q];
        }
      }
      at += __popc(bal[q]);
    }
  };
  const bool fast = src.scores != nullptr && src.vec;
  for (int i0 = warp; i0 < kc; i0 += kInFlight * kWarps) {
    float4 v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j * kWarps;
      const int blk = i < kc ? (int)chosen[i] : 0;
      if (fast && i < kc && (blk + 1) * kBlock <= src.width)
        v[j] = __ldg(reinterpret_cast<const float4*>(
                         src.scores + row * src.ld + blk * kBlock) + l);
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j * kWarps;
      if (i >= kc) break;  // warp-uniform
      const int blk = (int)chosen[i];
      uint64_t kk[4];
      int ll[4];
      if (fast && (blk + 1) * kBlock <= src.width) {
        const float f[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ll[q] = blk * kBlock + 4 * l + q;
          kk[q] = score_key(src, f[q], ll[q]);
        }
      } else {
        block_keys(src, row, blk, kk, ll);
      }
      keep(kk, ll);
    }
  }
  __syncthreads();
  const int n = sh.count;
  if (n <= kRank) {
    // few survivors (the common case): each one's rank among them (the
    // order is strict) places the chunk top without a sort
    uint64_t* top_key = sh.aux;
    uint32_t* top_lane = reinterpret_cast<uint32_t*>(sh.aux + kRank);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint64_t ki = sh.key[i];
      const uint32_t li = sh.lane[i];
      int rank = 0;
      for (int j = 0; j < n; ++j)
        rank += better(sh.key[j], sh.lane[j], ki, li);
      if (rank < kc) {
        top_key[rank] = ki;
        top_lane[rank] = li;
      }
    }
    __syncthreads();
    write_row(o, row, top_key, top_lane, sh.key);
    return;
  }
  if (n <= kSurv) {
    pad_and_sort(sh.key, sh.lane, n);
  } else {  // too many survivors: the exact cut over the chosen blocks
    if (!ordered) {  // in block order, as the ordered compaction needs
      collect(blocks, bcut, kc, nullptr, chosen, sh.scan);
      __syncthreads();
    }
    const Cands c{&src, row, nullptr, false, chosen, kc * kBlock, kChosen};
    const Cut cut = radix_cut(c, kc, sh.hist, sh.scan, sh.pick);
    collect(c, cut, kc, sh.key, sh.lane, sh.scan);
    __syncthreads();
    pad_and_sort(sh.key, sh.lane, kc);
  }
  write_row(o, row, sh.key, sh.lane, sh.aux);
}

// Regimes 1 and 2. Two-stage: CTA (row, tile) writes its tile's block
// maxima; the row's last CTA runs the row stage while other rows stream
// on. Row: one CTA a row, every lane a candidate.
__global__ void __launch_bounds__(kThreads, 2) select_chunk_kernel(
    Source src, int regime, int tiles, uint64_t* bm, unsigned* arrived,
    Out o) {
  extern __shared__ __align__(16) unsigned char smem[];
  ChunkShared& sh = *reinterpret_cast<ChunkShared*>(smem);
  const int l = threadIdx.x & 31;
  const int nb = (src.width + kBlock - 1) / kBlock;
  if (regime == kRow) {
    const long long row = blockIdx.x;
    const Cands c{&src, row, nullptr, false, nullptr, src.width, kLanes};
    const Cut cut = radix_cut(c, o.kc, sh.hist, sh.scan, sh.pick);
    collect(c, cut, o.kc, sh.key, sh.lane, sh.scan);
    __syncthreads();
    pad_and_sort(sh.key, sh.lane, o.kc);
    write_row(o, row, sh.key, sh.lane, sh.aux);
    return;
  }
  const long long row = blockIdx.x / tiles;
  tile_maxima(src, row, blockIdx.x % tiles, nb, bm);
  if (l < kInFlight) __threadfence();  // the lanes that wrote block maxima
  __syncthreads();
  if (threadIdx.x == 0)
    sh.last = atomicAdd(&arrived[row], 1u) == (unsigned)tiles - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  row_stage(src, row, nb, bm, o, sh);
}

// ---------------------------------------------------------------------------
// Regime 3: the multi-CTA radix select.

struct CutState {
  unsigned long long pre_hi, mask_hi;  // the cut's prefix over the key
  unsigned pre_lo, mask_lo;            // ... and over ~lane
  int need;                            // elements still wanted on the prefix
  int done;                            // every element on the prefix taken
};

struct RowState {
  CutState cut;
  unsigned arrived, n_cand, n_taken, pad;
  unsigned hist[256];
};

struct Pair {        // (rows, cap) elements
  uint64_t* key;
  uint32_t* lane;
  long long cap;
};

__device__ __forceinline__ unsigned digit(uint64_t key, uint32_t lane,
                                          int pass) {
  return pass < 8 ? (unsigned)(key >> (56 - 8 * pass)) & 255u
                  : (~lane >> (24 - 8 * (pass - 8))) & 255u;
}

// The element's prefix under the row's mask against the cut's: 1 above,
// 0 on it, -1 below.
__device__ __forceinline__ int vs_cut(uint64_t key, uint32_t lane,
                                      const CutState& s) {
  const uint64_t h = key & s.mask_hi;
  if (h != s.pre_hi) return h > s.pre_hi ? 1 : -1;
  const uint32_t lo = ~lane & s.mask_lo;
  return lo > s.pre_lo ? 1 : lo == s.pre_lo ? 0 : -1;
}

// Appends the elements of this warp lane that `take` (4 each) to row's
// part of buffer p, one global atomic a warp.
__device__ __forceinline__ void warp_append(const Pair& p, long long row,
                                            unsigned* count,
                                            const uint64_t k[4],
                                            const int ln[4],
                                            const bool take[4]) {
  const int l = threadIdx.x & 31;
  unsigned bal[4];
  int total = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bal[q] = __ballot_sync(kFullMask, take[q]);
    total += __popc(bal[q]);
  }
  if (total == 0) return;  // warp-uniform
  unsigned at = 0;
  if (l == 0) at = atomicAdd(count, (unsigned)total);
  at = __shfl_sync(kFullMask, at, 0);
  const unsigned below = (1u << l) - 1u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (take[q]) {
      const long long slot = row * p.cap + at + __popc(bal[q] & below);
      p.key[slot] = k[q];
      p.lane[slot] = (uint32_t)ln[q];
    }
    at += __popc(bal[q]);
  }
}

// One digit pass of the row's radix select. Passes 0 and 1 read the
// source's tile (tiles CTAs a row); pass 1 also moves the elements above
// pass 0's cut to `taken` and those on it to `cand`; passes 2-11 read the
// row's candidates, a slice a CTA. The row's last CTA picks the digit.
__global__ void __launch_bounds__(kThreads) select_radix_kernel(
    Source src, int pass, int tiles, RowState* st, Pair cand, Pair taken,
    int kc) {
  __shared__ unsigned s_hist[256];
  __shared__ int s_scan[32];
  __shared__ int s_pick[2];
  __shared__ int s_last;
  const long long row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  RowState* s = st + row;
  const CutState rs = s->cut;
  if (pass >= 2 && rs.done) return;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (pass < 2) {
    const int nb = (src.width + kBlock - 1) / kBlock;
    for (int j = 0; j < kPerWarp; ++j) {
      const int blk = tile * kTileBlocks + j * kWarps + warp;
      if (blk >= nb) break;  // warp-uniform
      uint64_t k[4];
      int ln[4];
      block_keys(src, row, blk, k, ln);
      bool gt[4], eq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = ln[q] < src.width;
        const int c = pass == 0 ? 0 : vs_cut(k[q], (uint32_t)ln[q], rs);
        gt[q] = ok && (c > 0 || (c == 0 && rs.done));
        eq[q] = ok && c == 0 && !rs.done;
        warp_hist(s_hist, eq[q] ? digit(k[q], (uint32_t)ln[q], pass) : 256u);
      }
      if (pass == 1) {
        warp_append(taken, row, &s->n_taken, k, ln, gt);
        warp_append(cand, row, &s->n_cand, k, ln, eq);
      }
    }
  } else {
    const long long n = s->n_cand;
    const long long per = (n + tiles - 1) / tiles;
    const long long i0 = tile * per, i1 = min(n, i0 + per);
    for (long long i = i0 + threadIdx.x; i - threadIdx.x < i1;
         i += blockDim.x) {
      unsigned d = 256u;
      if (i < i1) {
        const uint64_t key = cand.key[row * cand.cap + i];
        const uint32_t lane = cand.lane[row * cand.cap + i];
        if (vs_cut(key, lane, rs) == 0) d = digit(key, lane, pass);
      }
      warp_hist(s_hist, d);
    }
  }
  __syncthreads();
  if (pass == 1 && rs.done) return;  // nothing to pick
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    if (s_hist[i]) atomicAdd(&s->hist[i], s_hist[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&s->arrived, 1u) == (unsigned)tiles - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_hist[i] = __ldcg(&s->hist[i]);
    s->hist[i] = 0;
  }
  __syncthreads();
  const int need = pass == 0 ? kc : rs.need;
  pick_digit(s_hist, need, s_scan, s_pick);
  if (threadIdx.x == 0) {
    const unsigned d = (unsigned)s_pick[0];
    const int left = need - s_pick[1];
    CutState c = rs;
    if (pass < 8) {
      const int shift = 56 - 8 * pass;
      c.pre_hi |= (unsigned long long)d << shift;
      c.mask_hi |= 255ull << shift;
    } else {
      const int shift = 24 - 8 * (pass - 8);
      c.pre_lo |= d << shift;
      c.mask_lo |= 255u << shift;
    }
    c.need = left;
    c.done = (int)s_hist[d] == left;
    s->cut = c;
    s->arrived = 0;
  }
}

// Moves the row's candidates at or above the final cut to `taken`.
__global__ void __launch_bounds__(kThreads) select_collect_kernel(
    int tiles, RowState* st, Pair cand, Pair taken) {
  const long long row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const CutState rs = st[row].cut;
  const long long n = st[row].n_cand;
  const long long per = (n + tiles - 1) / tiles;
  const long long i0 = tile * per, i1 = min(n, i0 + per);
  for (long long b = i0 + 4 * (long long)(threadIdx.x & ~31);
       b < i1; b += 4 * (long long)blockDim.x) {
    uint64_t k[4];
    int ln[4];
    bool take[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long i = b + 32 * q + (threadIdx.x & 31);
      take[q] = false;
      k[q] = 0;
      ln[q] = 0;
      if (i < i1) {
        k[q] = cand.key[row * cand.cap + i];
        ln[q] = (int)cand.lane[row * cand.cap + i];
        take[q] = vs_cut(k[q], (uint32_t)ln[q], rs) >= 0;
      }
    }
    warp_append(taken, row, &st[row].n_taken, k, ln, take);
  }
}

// ---------------------------------------------------------------------------
// The grid-wide sort (regimes 3 and 4) and its pool merge.

// Tile t of each row (kSmallK elements of the row's lanes, or of its taken
// elements in `runs`) sorted, back into `runs`; a row of one tile goes to
// the outputs.
__global__ void __launch_bounds__(kThreads) select_sort_kernel(
    Source src, bool from_src, Pair runs, int tiles, Out o) {
  __shared__ uint64_t s_key[kSmallK];
  __shared__ uint32_t s_lane[kSmallK];
  const long long row = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * kSmallK;
  const int m = min(kSmallK, o.kc - t0);
  const long long at = row * runs.cap + t0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (from_src) {
      s_key[i] = src_key(src, row, t0 + i);
      s_lane[i] = (uint32_t)(t0 + i);
    } else {
      s_key[i] = runs.key[at + i];
      s_lane[i] = runs.lane[at + i];
    }
  }
  for (int i = m + threadIdx.x; i < kSmallK; i += blockDim.x) {
    s_key[i] = 0;
    s_lane[i] = 0xffffffffu;
  }
  __syncthreads();
  sort_tile<kMergeE>(s_key, s_lane);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (tiles == 1) {
      o.key[row * o.kc + i] = (int64_t)(s_key[i] ^ kSign);
      o.lane[row * o.kc + i] = (int64_t)s_lane[i];
    } else {
      runs.key[at + i] = s_key[i];
      runs.lane[at + i] = s_lane[i];
    }
  }
}

// Where a merge round's output chunk c (kSmallK elements) of a row starts
// in its pair of runs of w elements: the pair's start ps, its runs' lengths
// la and lb, and the chunk's first and last output d0, d1 past ps.
struct Chunk {
  int ps, la, lb, d0, d1;
};

__device__ __forceinline__ Chunk merge_chunk(int c, int w, int k) {
  const int s = c * kSmallK, ps = s / (2 * w) * (2 * w);
  const int la = min(w, k - ps), lb = max(0, min(w, k - ps - la));
  const int d0 = s - ps;
  return {ps, la, lb, d0, min(d0 + kSmallK, la + lb)};
}

// A merge round's splits: for each output chunk of each row, how many of
// its pair's first d0 outputs come from the first run. One thread a chunk,
// all in flight at once (a binary search is a chain of dependent loads).
__global__ void __launch_bounds__(kThreads) select_split_kernel(
    Pair in, int w, int chunks, int k, long long n, int* splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i / chunks;
  const Chunk c = merge_chunk((int)(i % chunks), w, k);
  const uint64_t* rk = in.key + row * in.cap + c.ps;
  const uint32_t* rl = in.lane + row * in.cap + c.ps;
  splits[i] = merge_split(rk, rl, c.la, rk + c.la, rl + c.la, c.lb, c.d0);
}

// One merge round: the sorted runs of w elements of `in` merged pairwise
// into `out`, or into the outputs when last. Each CTA makes one kSmallK
// chunk of a row's output (w is a multiple of kSmallK, so the chunk lies
// in one pair of runs), from the splits of select_split_kernel.
__global__ void __launch_bounds__(kThreads) select_merge_kernel(
    Pair in, Pair out, int w, int chunks, bool last, const int* splits,
    Out o) {
  __shared__ uint64_t s_key[kSmallK];
  __shared__ uint32_t s_lane[kSmallK];
  const long long row = blockIdx.x / chunks;
  const int k = o.kc;
  const int c = blockIdx.x % chunks, s = c * kSmallK;
  const Chunk ch = merge_chunk(c, w, k);
  const int ps = ch.ps, la = ch.la, d0 = ch.d0, d1 = ch.d1;
  const uint64_t* rk = in.key + row * in.cap + ps;
  const uint32_t* rl = in.lane + row * in.cap + ps;
  // a chunk that does not end its pair is followed by one in the pair
  const int a0 = splits[blockIdx.x];
  const int a1 = d1 == la + ch.lb ? la : splits[blockIdx.x + 1];
  const int n = d1 - d0, na = a1 - a0, b0 = d0 - a0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int at = i < na ? a0 + i : la + b0 + i - na;
    s_key[i] = rk[at];
    s_lane[i] = rl[at];
  }
  __syncthreads();
  const int e0 = min(n, (int)threadIdx.x * kMergeE);
  int a = merge_split(s_key, s_lane, na, s_key + na, s_lane + na, n - na, e0);
  int b = e0 - a;
  uint64_t ok[kMergeE];
  uint32_t ol[kMergeE];
#pragma unroll
  for (int j = 0; j < kMergeE; ++j) {
    if (e0 + j >= n) break;
    const bool from_a =
        b >= n - na || (a < na && better(s_key[a], s_lane[a], s_key[na + b],
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
    if (last) {
      o.key[row * k + s + i] = (int64_t)(s_key[i] ^ kSign);
      o.lane[row * k + s + i] = (int64_t)s_lane[i];
    } else {
      out.key[row * out.cap + s + i] = s_key[i];
      out.lane[row * out.cap + s + i] = s_lane[i];
    }
  }
}

// The merge of the sorted chunk top (o.key) with the running pool: one
// thread an element of either list.
__global__ void __launch_bounds__(kThreads) select_pool_kernel(Out o,
                                                               int per_row) {
  const long long row = blockIdx.x / per_row;
  const int i = (blockIdx.x % per_row) * blockDim.x + threadIdx.x;
  const int64_t* top = o.key + row * o.kc;
  const int64_t* brow = o.best + row * o.w0;
  const long long mo = row * o.wm;
  const auto best_at = [brow](int j) { return (uint64_t)brow[j] ^ kSign; };
  const auto top_at = [top](int j) { return (uint64_t)top[j] ^ kSign; };
  if (i < o.kc) {
    const int p = i + leading(best_at, o.w0, top_at(i), false);
    if (p < o.wm) {
      o.m_key[mo + p] = top[i];
      o.m_pos[mo + p] = o.w0 + i;
    }
  } else if (i < o.kc + o.w0) {
    const int j = i - o.kc;
    const int p = j + leading(top_at, o.kc, best_at(j), true);
    if (p < o.wm) {
      o.m_key[mo + p] = brow[j];
      o.m_pos[mo + p] = j;
    }
  }
}

// ---------------------------------------------------------------------------
// The workspace of one call, carved from one buffer (256-byte aligned
// pieces).

struct Work {
  unsigned* arrived;   // two-stage: (rows) arrival counters, zeroed per call
  uint64_t* bm;        // two-stage: (rows, nb) block maxima
  RowState* state;     // radix: (rows) row states, zeroed per call
  Pair cand;           // radix: (rows, width) candidates
  Pair runs[2];        // radix, full: (rows, kc) sort buffers
  int* splits;         // radix, full: (rows, ceil(kc / kSmallK)) splits
  long long zero_bytes;  // the prefix zeroed before the launches
  long long bytes;
};

inline long long up256(long long n) { return (n + 255) / 256 * 256; }

Work plan(int regime, long long rows, long long width, long long kc,
          unsigned char* base) {
  Work w{};
  long long at = 0;
  auto take = [&](long long n) {
    unsigned char* p = base ? base + at : nullptr;
    at += up256(n);
    return p;
  };
  if (regime == kTwoStage) {
    w.arrived = reinterpret_cast<unsigned*>(take(rows * 4));
    w.zero_bytes = at;
    w.bm = reinterpret_cast<uint64_t*>(
        take(rows * ((width + kBlock - 1) / kBlock) * 8));
  } else if (regime == kRadix || regime == kFull) {
    if (regime == kRadix) {
      w.state = reinterpret_cast<RowState*>(take(rows * sizeof(RowState)));
      w.zero_bytes = at;
      w.cand.key = reinterpret_cast<uint64_t*>(take(rows * width * 8));
      w.cand.lane = reinterpret_cast<uint32_t*>(take(rows * width * 4));
      w.cand.cap = width;
    }
    for (Pair& r : w.runs) {
      r.key = reinterpret_cast<uint64_t*>(take(rows * kc * 8));
      r.lane = reinterpret_cast<uint32_t*>(take(rows * kc * 4));
      r.cap = kc;
    }
    w.splits = reinterpret_cast<int*>(
        take(rows * ((kc + kSmallK - 1) / kSmallK) * 4));
  }
  w.bytes = at;
  return w;
}

int sort_rows(const Source& src, bool from_src, Work& w, int rows,
              const Out& o, cudaStream_t s) {
  const int tiles = (o.kc + kSmallK - 1) / kSmallK;
  select_sort_kernel<<<rows * tiles, kThreads, 0, s>>>(src, from_src,
                                                       w.runs[0], tiles, o);
  int err = mvs_launch_status();
  int cur = 0;
  const long long n = (long long)rows * tiles;
  for (int width = kSmallK; err == 0 && width < o.kc; width *= 2) {
    const bool last = 2 * width >= o.kc;
    select_split_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(w.runs[cur], width, tiles, o.kc,
                                            n, w.splits);
    err = mvs_launch_status();
    if (err != 0) break;
    select_merge_kernel<<<rows * tiles, kThreads, 0, s>>>(
        w.runs[cur], w.runs[1 - cur], width, tiles, last, w.splits, o);
    err = mvs_launch_status();
    cur = 1 - cur;
  }
  if (err != 0 || o.wm == 0) return err;
  const int per_row = (o.kc + o.w0 + kThreads - 1) / kThreads;
  select_pool_kernel<<<rows * per_row, kThreads, 0, s>>>(o, per_row);
  return mvs_launch_status();
}

}  // namespace

// Bytes of the workspace mvs_select takes for this regime and shape.
MVS_EXPORT long long mvs_select_work_bytes(int regime, int rows, int width,
                                           int kc) {
  return plan(regime, rows, width, kc, nullptr).bytes;
}

// scores (float32) or keys (int64): (rows, width) with row stride ld, one
// of them null. Lane l < valid carries the index base + l, any other lane
// the index none (scores only). kc in [1, width]. regime: 0 two-stage (kc <
// ceil(width / 128) and kc <= 2048), 1 row (kc <= 2048), 2 radix (kc <
// width), 3 full (kc = width), as ann/select.py::regime chooses. work:
// mvs_select_work_bytes(regime, rows, width, kc) bytes, 256-byte aligned.
// out_key / out_lane: (rows, kc) int64. best: (rows, w0) int64 keys sorted
// descending (the previous merge's output); wm = 0 skips the merge, else
// m_key / m_pos (rows, wm) int64 with wm <= w0 + kc.
MVS_EXPORT int mvs_select(const void* scores, const void* keys, long long ld,
                          int rows, int width, long long base,
                          long long valid, long long none, int kc,
                          int regime, void* work, void* out_key,
                          void* out_lane, const void* best, int w0, int wm,
                          void* m_key, void* m_pos, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t p = (uintptr_t)(scores ? scores : keys);
  const int elem = scores ? 4 : 8;
  const bool vec = p % 16 == 0 && (ld * elem) % 16 == 0;
  const Source src{(const float*)scores, (const int64_t*)keys, ld, width,
                   base, valid, none, vec};
  const Out o{(int64_t*)out_key, (int64_t*)out_lane, (const int64_t*)best,
              kc, w0, wm, (int64_t*)m_key, (int64_t*)m_pos};
  Work w = plan(regime, rows, width, kc, (unsigned char*)work);
  if (w.zero_bytes) {
    const cudaError_t e = cudaMemsetAsync(work, 0, w.zero_bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (width + kTile - 1) / kTile;
  if (regime == kTwoStage || regime == kRow) {
    const int bytes = (int)sizeof(ChunkShared);
    const cudaError_t e = cudaFuncSetAttribute(
        select_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    const int t = regime == kTwoStage ? tiles : 1;
    select_chunk_kernel<<<rows * t, kThreads, bytes, s>>>(
        src, regime, t, w.bm, w.arrived, o);
    return mvs_launch_status();
  }
  if (regime == kRadix) {
    const int ctiles = (tiles + 3) / 4;  // CTAs a row over the candidates
    for (int pass = 0; pass < kPasses; ++pass) {
      const int t = pass < 2 ? tiles : ctiles;
      select_radix_kernel<<<rows * t, kThreads, 0, s>>>(
          src, pass, t, w.state, w.cand, w.runs[0], kc);
      int err = mvs_launch_status();
      if (err != 0) return err;
    }
    select_collect_kernel<<<rows * ctiles, kThreads, 0, s>>>(
        ctiles, w.state, w.cand, w.runs[0]);
    int err = mvs_launch_status();
    if (err != 0) return err;
  }
  return sort_rows(src, regime == kFull, w, rows, o, s);
}
