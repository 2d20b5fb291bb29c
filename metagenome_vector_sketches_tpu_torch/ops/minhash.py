"""MinHash strategy (the reference's historical ``--strategy 1``): EXACT
pairwise intersections of the raw FracMinHash sets, a shard's rows at a
time.

The JAX package (``metagenome_vector_sketches_tpu/ops/minhash.py``) forms
the whole (N x N) intersection matrix as M @ M^T over the dense 0/1
incidence M of the sets on the hash universe, in universe chunks: N^2 U
work whatever the sparsity, and every shard computes all N rows. Real
collections share hashes unevenly (the same species sequenced many times,
spike-ins, host contamination): a few hashes are held by many sets and
most by one or a few. So the port splits the work by a hash's posting
length p_h, the number of sets that hold it:

1. Staging (:func:`stage_sets`, once a collection): the (hash, set) pairs
   are sorted by hash on the device (a set's repeated hash counted once);
   hashes held by one set add only to the diagonal |A| and are dropped; the
   heavy ones (p_h at least :func:`heavy_threshold` of the collection)
   become an (N, H) int8 incidence, the light ones stay CSR postings (each
   hash's ascending set ids).
2. A shard's rows [b, e) (:func:`shard_triples`) accumulate an (e - b) x N
   int32 matrix C (exact: an intersection is at most min(|A|, |B|) <
   2^31): the heavy part C = A[b:e] . A^T (kernel G, ``csrc/sweep.cu``
   ``mvs_gram_rows``), then the light part, one increment
   a (member in [b, e), member) pair of each light posting (kernel C,
   ``csrc/minhash.cu`` ``mvs_cooc``).
3. Kernel M (``mvs_minhash_keep``) applies the reference's retention test
   inter > 0.05 (|A| + |B|) in float64 to every pair of the rows, the
   diagonal reading |A|, and compacts the kept (row, column, inter) triples
   on the card; they are copied back once.

Every kernel has its plain PyTorch version here, which the wrappers run for
CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..utils.profiling import stage
from .pairwise import D_ALIGN, SWEEP_BLOCK, pad_rows

# A hash held by p sets costs a shard of r rows 2 r N int8 operations in
# kernel G when heavy, and about p^2 r / N increments in kernel C when light
# (p r / N of its members fall in the rows, each against p): the two meet at
# p = N sqrt(2 R_C / R_G) for kernel C's increment rate R_C and kernel G's
# operation rate R_G. On an H100 (PERF.md kernel table: G 1.27e15 ops/s,
# C 5.4e10 increments/s) that is N / 108; a sweep of the threshold at the
# benchmark's MinHash collection (N = 24,576, PERF.md §6) measured a
# shard's three kernels at 8.4 ms at N / 96 = 256, 9.5 at 128, 10.1 at 512.
# So postings of at least N / HEAVY_PER sets go heavy
HEAVY_PER = 96
# at most this many bytes of heavy incidence (N x H int8): past it only the
# longest postings go heavy, the rest stay light
HEAVY_BYTES = 8 << 30
# first capacity (pairs) of kernel M's kept-pair buffer; grows to the
# largest kept count a shard needed
KEEP_CAP_START = 1 << 16
# rows a block of :func:`pairwise_intersections`
ROWS_PER_BLOCK = 1 << 12

# stage walls (ms) and counters of the LAST shard_triples call made by
# pairwise_intersections / minhash_triples (compute_minhash_shard records
# into matrix.compute.LAST_STAGES), each wall with the profiler span of the
# same block (utils.profiling.stage): stage_ms (mvs.minhash.stage) the
# staging; heavy_ms (mvs.minhash.heavy) kernel G, light_ms
# (mvs.minhash.light) kernel C, keep_ms (mvs.minhash.keep) kernel M and the
# copies, each synchronised. Counters: heavy_min (the threshold),
# heavy_hashes, light_postings, light_entries (the postings' members),
# light_cooccurrences (kernel C's increments), emitted (the pairs tested),
# kept, blocks
LAST_STAGES: dict = {}


def _set_sizes(hash_sets) -> np.ndarray:
    """Unique-element count per input (sets, lists, or arrays)."""
    return np.array(
        [len(s) if isinstance(s, (set, frozenset))
         else len(np.unique(np.asarray(list(s), dtype=np.uint64)))
         for s in hash_sets], dtype=np.int64)


def _as_array(s) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return s.astype(np.uint64, copy=False)
    return np.asarray(list(s), dtype=np.uint64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------- staging

@dataclass
class Staged:
    """One collection's sets as the shard engine holds them on a device:
    ``sizes`` (N,) int64; ``heavy`` the (n_pad, h_pad) int8 incidence of the
    heavy hashes (None when there are none); ``post_sets`` / ``post_off``
    the light postings (int32 members, ascending within a posting; int64
    offsets); the threshold that split them, the counts of each and the
    kept-pair capacity reached."""
    n: int
    sizes: torch.Tensor
    heavy: torch.Tensor | None
    heavy_min: int
    n_heavy: int
    post_sets: torch.Tensor
    post_off: torch.Tensor
    keep_cap: int = KEEP_CAP_START

    @property
    def n_post(self) -> int:
        return len(self.post_off) - 1


def heavy_threshold(p: torch.Tensor, n: int) -> int:
    """The posting length from which a hash of a collection of ``n`` sets
    goes heavy, given every hash's posting length ``p``: N / HEAVY_PER (at
    least 2: a posting of one set is dropped), raised until the heavy
    incidence fits in HEAVY_BYTES."""
    t = max(2, -(-n // HEAVY_PER))
    fit = HEAVY_BYTES // max(1, pad_rows(n, p.device)) // D_ALIGN * D_ALIGN
    longer = p[p >= t]
    if len(longer) > fit:
        # the fit longest postings, less those tied with the first left out
        t = int(torch.topk(longer, fit + 1).values[-1]) + 1
    return t


def stage_sets(hash_sets, *, device) -> Staged:
    """Stage a collection (uint64 hash arrays, sets or lists, one a set) on
    ``device``: sort its (hash, set) pairs by hash, count each hash's
    postings, drop the hashes of one set, and split the rest at
    :func:`heavy_threshold` into the heavy incidence and the light
    postings."""
    dev = resolve_device(device)
    arrs = [_as_array(s) for s in hash_sets]
    n = len(arrs)
    lens = np.fromiter((len(a) for a in arrs), dtype=np.int64, count=n)
    flat = np.concatenate(arrs).view(np.int64) if lens.sum() \
        else np.empty(0, dtype=np.int64)
    h = torch.from_numpy(flat).to(dev)
    s = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        torch.from_numpy(lens).to(dev))
    # stable: the sets of one hash stay ascending; equal 64-bit patterns are
    # equal hashes, whatever order the signed view sorts them in
    h, order = torch.sort(h, stable=True)
    s = s[order]
    del order
    new = torch.ones(len(h), dtype=torch.bool, device=dev)
    new[1:] = h[1:] != h[:-1]
    twice = torch.zeros_like(new)
    twice[1:] = ~new[1:] & (s[1:] == s[:-1])   # a hash a set lists twice
    s, new = s[~twice], new[~twice]
    del h, twice
    sizes = torch.bincount(s.long(), minlength=n)
    run = torch.cumsum(new, 0) - 1
    p = torch.bincount(run)
    p_of = p[run]
    heavy_min = heavy_threshold(p, n)
    heavy_run = p >= heavy_min
    n_heavy = int(heavy_run.sum())
    heavy = None
    if n_heavy:
        col = (torch.cumsum(heavy_run, 0) - 1)[run]
        on = p_of >= heavy_min
        h_pad = (n_heavy + D_ALIGN - 1) // D_ALIGN * D_ALIGN \
            if dev.type == "cuda" else n_heavy
        heavy = torch.zeros((pad_rows(n, dev), h_pad), dtype=torch.int8,
                            device=dev)
        heavy.view(-1)[s[on].long() * h_pad + col[on]] = 1
        del col, on
    light = (p_of >= 2) & (p_of < heavy_min)
    post_sets = s[light].contiguous()
    lens_l = p[(p >= 2) & ~heavy_run]
    post_off = torch.zeros(len(lens_l) + 1, dtype=torch.int64, device=dev)
    post_off[1:] = torch.cumsum(lens_l, 0)
    return Staged(n=n, sizes=sizes, heavy=heavy, heavy_min=heavy_min,
                  n_heavy=n_heavy,
                  post_sets=post_sets, post_off=post_off)


# ---------------------------------------------------------------- kernel G

def _check_incidence(A: torch.Tensor) -> None:
    n, u = A.shape
    if A.dtype != torch.int8 or A.ndim != 2 or not A.is_contiguous() \
            or A.data_ptr() % 16:
        raise ValueError("A must be a contiguous 16-byte aligned (n, u) int8 "
                         "tensor")
    if n % SWEEP_BLOCK or u % D_ALIGN or n == 0 or u == 0:
        raise ValueError(f"kernel G takes n a multiple of {SWEEP_BLOCK} and u "
                         f"of {D_ALIGN} (got {n} x {u})")


def gram_rows_plain(A: torch.Tensor, b: int, e: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gram_rows`: the (e - b, n) rows, as
    the float64 product (exact below 2^53)."""
    A64 = A.to(torch.float64)
    return (A64[b:e] @ A64.T).to(torch.int32)


def gram_rows(A: torch.Tensor, b: int, e: int) -> torch.Tensor:
    """Rows b..e-1 of A @ A^T for an (n, u) int8 incidence A: on CUDA
    (kernel G, one launch) a new (rows_pad, n) int32
    tensor, rows_pad = e - b rounded up to 128, its pad rows 0; n must be a
    multiple of 128 and u of 64."""
    if A.device.type == "cpu":
        return gram_rows_plain(A, b, e)
    _check_incidence(A)
    n, u = A.shape
    if not 0 <= b < e <= n:
        raise ValueError(f"rows {b}..{e} outside the incidence's {n}")
    C = torch.empty((pad_rows(e - b, A.device), n), dtype=torch.int32,
                    device=A.device)
    lib = _build.library()
    with _build.launch_stream(A.device) as stream:
        err = lib.mvs_gram_rows(A.data_ptr(), n, u, b, e - b, C.data_ptr(),
                                n, stream)
    _build.check(err, "gram rows kernel")
    _build.count_launch("gram")
    return C


# ---------------------------------------------------------------- kernel C

def cooc_accumulate_plain(C: torch.Tensor, post_sets: torch.Tensor,
                          post_off: torch.Tensor, b: int, e: int,
                          count: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cooc_accumulate`."""
    dev = C.device
    p = post_off[1:] - post_off[:-1]
    post_of = torch.repeat_interleave(torch.arange(len(p), device=dev), p)
    s = post_sets.long()
    mine = torch.nonzero((s >= b) & (s < e)).flatten()
    q = post_of[mine]
    cnt = p[q]
    total = int(cnt.sum())
    rows = torch.repeat_interleave(s[mine] - b, cnt)
    idx = torch.repeat_interleave(post_off[q], cnt) + (
        torch.arange(total, device=dev)
        - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt))
    C.view(-1).index_add_(0, rows * C.stride(0) + s[idx],
                          torch.ones(total, dtype=C.dtype, device=dev))
    count += total
    return C


def cooc_accumulate(C: torch.Tensor, post_sets: torch.Tensor,
                    post_off: torch.Tensor, b: int, e: int,
                    count: torch.Tensor) -> torch.Tensor:
    """C[i - b, j] += 1, in place, for each light posting, each of its
    members i in [b, e) and each of its members j; count ((1,) int64) +=
    the increments. On CUDA kernel C (one launch), which never waits for
    the device."""
    if C.device.type == "cpu":
        return cooc_accumulate_plain(C, post_sets, post_off, b, e, count)
    dev = C.device
    if C.dtype != torch.int32 or C.ndim != 2 or not C.is_contiguous() \
            or C.shape[0] < e - b:
        raise ValueError(f"C must be a contiguous (>= {e - b}, n) int32 "
                         "tensor")
    if post_sets.dtype != torch.int32 or post_off.dtype != torch.int64 \
            or count.dtype != torch.int64 or not post_sets.is_contiguous() \
            or not post_off.is_contiguous() \
            or {post_sets.device, post_off.device, count.device} != {dev}:
        raise ValueError("postings: contiguous int32 members and int64 "
                         "offsets, and an int64 count, on C's device")
    lib = _build.library()
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_cooc(post_sets.data_ptr(), post_off.data_ptr(),
                           len(post_off) - 1, b, e, C.data_ptr(),
                           C.stride(0), count.data_ptr(), stream)
    _build.check(err, "cooc kernel")
    _build.count_launch("cooc")
    return C


# ---------------------------------------------------------------- kernel M

def keep_shard_plain(C: torch.Tensor, sizes: torch.Tensor, b: int, e: int,
                     cap: int):
    """Plain PyTorch version of :func:`keep_shard`; kept pairs in row-major
    order."""
    n = len(sizes)
    r = e - b
    inter = C[:r, :n].long()
    i = torch.arange(r, device=C.device)
    inter[i, b + i] = sizes[b:e]
    thr = 0.05 * (sizes[b:e, None] + sizes[None, :]).to(torch.float64)
    rr, cc = torch.nonzero(inter.to(torch.float64) > thr, as_tuple=True)
    kept = len(rr)
    out = torch.zeros((cap, 2), dtype=torch.int64, device=C.device)
    m = min(cap, kept)
    out[:m, 0] = (rr[:m] + b) | (cc[:m] << 32)
    out[:m, 1] = inter[rr[:m], cc[:m]]
    return out, torch.tensor([kept], dtype=torch.int64, device=C.device)


def keep_shard(C: torch.Tensor, sizes: torch.Tensor, b: int, e: int,
               cap: int):
    """Kernel M: every pair (i, j) of rows b..e-1 against the n = len(sizes)
    sets, its intersection C[i - b, j] (|A_i| on the diagonal), kept where
    inter > 0.05 (|A_i| + |A_j|) in float64. -> (out (cap, 2) int64: kept
    pairs as (row | column << 32, inter), the first min(kept, cap) in no
    fixed order; kept (1,) int64, exact past cap), on C's device; the call
    never waits for the device."""
    if C.device.type == "cpu":
        return keep_shard_plain(C, sizes, b, e, cap)
    dev = C.device
    n = len(sizes)
    if C.dtype != torch.int32 or C.ndim != 2 or not C.is_contiguous() \
            or C.shape[0] < e - b or C.shape[1] < n:
        raise ValueError(f"C must be a contiguous (>= {e - b}, >= {n}) int32 "
                         "tensor")
    if sizes.dtype != torch.int64 or not sizes.is_contiguous() \
            or sizes.device != dev:
        raise ValueError("sizes must be a contiguous int64 tensor on C's "
                         "device")
    out = torch.empty((cap, 2), dtype=torch.int64, device=dev)
    kept = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build.library()
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_minhash_keep(C.data_ptr(), C.stride(0), e - b, n, b,
                                   sizes.data_ptr(), out.data_ptr(), cap,
                                   kept.data_ptr(), stream)
    _build.check(err, "minhash keep kernel")
    _build.count_launch("mhkeep")
    return out, kept


# ---------------------------------------------------------------- a shard

def shard_counts(st: Staged, b: int, e: int, record: dict) -> tuple:
    """The shard's accumulator: heavy part (kernel G), then the light
    postings (kernel C), each stage synchronised. -> (C, the increments as
    a (1,) int64 device tensor)."""
    dev = st.sizes.device
    with stage("mvs.minhash.heavy", record, "heavy_ms"):
        if st.heavy is not None:
            C = gram_rows(st.heavy, b, e)
        else:
            C = torch.zeros((pad_rows(e - b, dev), pad_rows(st.n, dev)),
                            dtype=torch.int32, device=dev)
        _sync(dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    with stage("mvs.minhash.light", record, "light_ms"):
        if st.n_post:
            cooc_accumulate(C, st.post_sets, st.post_off, b, e, count)
        _sync(dev)
    return C, count


def shard_triples(st: Staged, b: int, e: int, record: dict) -> tuple:
    """Rows [b, e) of the collection: (rows, cols, inter) int64 arrays of
    the kept pairs, in row-major order (sorted on the device, so the
    writer finds them in order and sorts nothing). ``record`` gets the
    stage walls and the counters (module LAST_STAGES)."""
    for k in ("heavy_ms", "light_ms", "keep_ms"):
        record.setdefault(k, 0.0)
    record.update(heavy_min=st.heavy_min, heavy_hashes=st.n_heavy,
                  light_postings=st.n_post,
                  light_entries=len(st.post_sets), light_cooccurrences=0,
                  emitted=max(0, e - b) * st.n, kept=0)
    if e <= b:
        e0 = np.empty(0, dtype=np.int64)
        return e0, e0.copy(), e0.copy()
    C, count = shard_counts(st, b, e, record)
    with stage("mvs.minhash.keep", record, "keep_ms"):
        out, kept = keep_shard(C, st.sizes, b, e, st.keep_cap)
        got = torch.cat([kept, count]).cpu().numpy()
        if int(got[0]) > st.keep_cap:
            st.keep_cap = int(got[0])
            out, kept = keep_shard(C, st.sizes, b, e, st.keep_cap)
        pairs = out[:int(got[0])]
        key, order = torch.sort(((pairs[:, 0] & 0xFFFFFFFF) << 32)
                                | (pairs[:, 0] >> 32))
        host = torch.stack([key, pairs[order, 1]]).cpu().numpy()
    del C, out, pairs
    record.update(light_cooccurrences=int(got[1]), kept=int(got[0]))
    return host[0] >> 32, host[0] & 0xFFFFFFFF, host[1]


# ---------------------------------------------------------------- the APIs

def pairwise_intersections(hash_sets, rows_per_block: int = ROWS_PER_BLOCK,
                           *, device) -> np.ndarray:
    """Exact (N, N) int64 intersection-count matrix, the shard engine's
    accumulator of ``rows_per_block`` rows at a time copied back whole."""
    dev = resolve_device(device)
    LAST_STAGES.clear()
    LAST_STAGES.update(stage_ms=0.0, blocks=0)
    with stage("mvs.minhash.stage", LAST_STAGES, "stage_ms"):
        st = stage_sets(hash_sets, device=dev)
    n = st.n
    out = np.zeros((n, n), dtype=np.int64)
    for b in range(0, n, rows_per_block):
        e = min(n, b + rows_per_block)
        C, _ = shard_counts(st, b, e, LAST_STAGES)
        out[b:e] = C[:e - b, :n].cpu().numpy()
        LAST_STAGES["blocks"] += 1
    i = np.arange(n)
    out[i, i] = st.sizes.cpu().numpy()
    return out


def pairwise_jaccard_minhash(hash_sets, *,
                             device) -> tuple[np.ndarray, np.ndarray]:
    """-> (jaccard (N,N) float64, sizes (N,)) — exact set Jaccard:
    J = |A&B| / (|A| + |B| - |A&B|)."""
    inter = pairwise_intersections(hash_sets, device=device)
    sizes = _set_sizes(hash_sets)
    union = sizes[:, None] + sizes[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        jac = np.where(union > 0, inter / union, 0.0)
    return jac, sizes


def minhash_triples(hash_sets, *, device):
    """Surviving (row, col, value) triples under the reference retention rule
    expressed on the true sets: keep iff intersection > 0.05*(|A|+|B|)
    (float64, as the JAX package), in row-major order. `value` is the raw
    intersection count, analogous to dot/d of the sketch path."""
    dev = resolve_device(device)
    LAST_STAGES.clear()
    LAST_STAGES.update(stage_ms=0.0)
    with stage("mvs.minhash.stage", LAST_STAGES, "stage_ms"):
        st = stage_sets(hash_sets, device=dev)
    r, c, inter = shard_triples(st, 0, st.n, LAST_STAGES)
    return r, c, inter, st.sizes.cpu().numpy()
