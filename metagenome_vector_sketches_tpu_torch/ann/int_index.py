"""Exact cosine top-k over INTEGER sketch vectors via int8 Karatsuba planes.

Port of ``metagenome_vector_sketches_tpu/ann/int_index.py`` (the int8
serving engine of the jaccard ANN path). The integer database is
decomposed once into P = L(L+1)/2 int8 planes, resident on the device as a
(C, P, R_pad, d_pad) stack of C chunks of R = chunk_rows rows; on CUDA
R_pad rounds R up to a multiple of 128 with zero planes (kernel S's block),
on the CPU R_pad = R. A query batch is scanned chunk by chunk:

1. kernel S, SCORE epilogue (``ops.pairwise.scan_scores``): the plane-order
   float32 combine of the exact plane products times 1/|v|, -inf on lanes
   past the chunk's valid rows;
2. kernel K (``ann.select.select_chunk``): the chunk's top-``kc``, merged
   into the running top-``pool`` (exact, lowest index first among equal
   scores — the tie order of ``jax.lax.top_k``);
3. kernel X (``ops.pairwise.pair_partials`` with two operands) on the
   chunk's selected (query, row) pairs: exact int32 limb-pair partials,
   carried through the merge;
4. after the last chunk, ONE device->host copy; the host recombines the
   partials into exact int64 dots and ranks by float64 cosine
   dot / sqrt(|v|^2 |q|^2), then (score desc, index asc) — as the JAX
   engine's finalize does.

mode 'exact' | 'approx' and recall_target are kept for the interface; the
JAX engine's approximate selectors (``approx_max_k``, ``selector=
"partial"``) are TPU lowerings that reduce to exact top-k on its CPU
backend, and the port selects exactly in every mode.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..io.dbfolder import DbFolder
from ..ops import pairwise as pw
from ..ops import pairwise_math as pm
from .select import key_index, key_scores, select_chunk

# per-stage wall split of the LAST IntExactIndex.search() call (the keys of
# the JAX engine's): prep_ms (query planes on the device), dispatch_ms
# (enqueue of the chunk scans), device_d2h_ms (the one device->host copy,
# which waits for the scans), d2h_bytes, finalize_ms (host exact
# recombine + rank)
LAST_SEARCH_STAGES: dict = {}

# int64 bytes of one block of the exact squared-norm computation
_NORM_BLOCK_BYTES = 256 << 20


def _inv_norms(ns, C: int, R: int, R_pad: int, n: int) -> np.ndarray:
    """(C, R_pad) float32 1/sqrt(|v|^2) ranking weights (0 for zero rows
    and pad lanes) from the exact int64 squared norms of the n rows."""
    inv = np.zeros((C, R_pad), dtype=np.float32)
    flat = np.sqrt(np.asarray(ns, dtype=np.float64))
    with np.errstate(divide="ignore"):
        iv = np.where(flat > 0, 1.0 / flat, 0.0).astype(np.float32)
    full = np.zeros(C * R, dtype=np.float32)
    full[:n] = iv
    inv[:, :R] = full.reshape(C, R)
    return inv


def _exact_norms(block: torch.Tensor) -> torch.Tensor:
    """(rows, d) integer tensor -> (rows,) exact int64 |v|^2, in row blocks
    so the int64 temporaries stay small."""
    out = torch.empty(block.shape[0], dtype=torch.int64, device=block.device)
    step = max(1, _NORM_BLOCK_BYTES // (8 * max(1, block.shape[1])))
    for s in range(0, block.shape[0], step):
        b = block[s:s + step].to(torch.int64)
        out[s:s + step] = (b * b).sum(dim=1)
    return out


def query_planes(Q: np.ndarray, L: int, dev) -> torch.Tensor:
    """(B, d) integer queries -> (P, pad_rows(B), d_pad) int8 planes on dev
    (zero planes on the pad rows and columns)."""
    B, d = Q.shape
    out = torch.zeros((pm.num_planes(L), pw.pad_rows(B, dev), pw.pad_dim(d)),
                      dtype=torch.int8, device=dev)
    if B:
        q = torch.from_numpy(np.ascontiguousarray(Q, dtype=np.int32)).to(dev)
        pw.planes_update(out, pw.decompose_limbs(q, L), 0)
    return out


def gather_rows(qp: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Rows ``sel`` of (P, rows, d_pad) query planes -> (P,
    pad_rows(len(sel)), d_pad), zero planes on the pad rows."""
    P, _, d_pad = qp.shape
    out = torch.zeros((P, pw.pad_rows(len(sel), qp.device), d_pad),
                      dtype=torch.int8, device=qp.device)
    out[:, :len(sel)] = qp[:, sel]
    return out


def chunk_layout(C: int, R: int, n: int) -> tuple[list, list]:
    """(bases, valid) of a stack of C chunks of R rows that holds rows
    0 .. n - 1 in order: chunk c holds rows c * R .. c * R + valid[c] - 1."""
    bases = [c * R for c in range(C)]
    return bases, [max(0, min(n - b, R)) for b in bases]


def _int_scan_pool(q_planes: torch.Tensor, B: int, stack: torch.Tensor,
                   inv_n: torch.Tensor, n_total: int, R: int, pool: int,
                   L: int, flag: torch.Tensor, bases, valid):
    """Whole-index candidate pooling of the first B query rows of q_planes
    ((P, B_pad, d_pad) int8) over the (C, P, R_pad, d_pad) stack.

    Chunk c holds the global rows bases[c] .. bases[c] + valid[c] - 1 (JAX
    ``_int_scan_pool``'s explicit per-chunk layout, so a mesh slot's chunks
    and per-process row blocks keep their global indices; a single-device
    stack's is :func:`chunk_layout`). Every global index is below
    n_total.

    -> (scores (B, pool_eff) float32 device ranking scores, indices
    (B, pool_eff) int64 global rows (-1 for none), partials (B, pool_eff,
    P) int32 kernel X partials), on the device, in (score desc, index asc)
    order. Kernel X counts out-of-range pairs into ``flag``
    (``pw.range_flag``), which the caller reads with
    ``pw.check_range_flag`` where it next synchronises."""
    C, P = stack.shape[:2]
    dev = stack.device
    pool_eff = min(pool, C * R)
    kc = min(pool_eff, R)
    rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None] \
        .expand(B, kc)
    best = torch.empty((B, 0), dtype=torch.int64, device=dev)
    best_p = torch.empty((B, 0, P), dtype=torch.int32, device=dev)
    for c in range(C):
        base, val = int(bases[c]), int(valid[c])
        score = pw.scan_scores(q_planes, stack[c], inv_n[c], val)[:B]
        # kernel K; invalid lanes all carry the index n_total (decoded to -1)
        _, sel, best, pos = select_chunk(score, base, val, n_total, kc, best,
                                         pool_eff)
        rc = torch.stack([rows, sel.to(torch.int32)], dim=2).reshape(-1, 2)
        parts = pw.pair_partials(q_planes, rc, L, stack[c], flag) \
            .reshape(B, kc, P)
        best_p = torch.gather(torch.cat([best_p, parts], dim=1), 1,
                              pos[:, :, None].expand(-1, -1, P))
    idx = key_index(best)
    return key_scores(best), torch.where(idx < n_total, idx, -1), best_p


def _dbfolder_staging(db_folder: str, chunk_rows: int):
    """Host side of db-folder staging (JAX ``_dbfolder_staging``):
    memory-mapped reads, exact int64 norms and the stale-sidecar check on a
    one-deep prefetch thread. Returns (n, d, max_abs, R, C, ns, iterator);
    the iterator yields (c, (rows, d) int32 block) in chunk order and
    ``ns`` is complete once it is exhausted."""
    from ..matrix.compute import scan_max_abs
    db = DbFolder(db_folder)
    n, d = db.num_vectors, db.dimension
    vec_dt = np.int16 if db.dtype == "int16" else np.int32
    V = np.memmap(os.path.join(db_folder, "vectors.bin"), dtype=vec_dt,
                  mode="r", shape=(n, d))
    R = int(min(chunk_rows, max(1, n)))
    C = (n + R - 1) // R
    max_abs = int(scan_max_abs(db, chunk=R))
    pm.check_exact_dot_range(d, max(1, max_abs))
    ns = np.empty(n, dtype=np.int64)

    def prepare(c):
        s, e = c * R, min((c + 1) * R, n)
        block = np.array(V[s:e], dtype=np.int32)
        true_max = max(int(block.max()), -int(block.min())) if block.size \
            else 0
        if true_max > max_abs:
            raise ValueError(
                f"max_component.txt ({max_abs}) is stale: vectors.bin holds "
                f"|component| up to {true_max}. Delete "
                f"{os.path.join(db.path, 'max_component.txt')} or rebuild "
                "the db folder.")
        b64 = block.astype(np.int64)
        ns[s:e] = np.einsum("ij,ij->i", b64, b64)
        return block

    def chunks():
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as tp:
            fut = tp.submit(prepare, 0)
            for c in range(C):
                block = fut.result()
                if c + 1 < C:
                    fut = tp.submit(prepare, c + 1)
                yield c, block

    return n, d, max_abs, R, C, ns, chunks()


class IntExactIndex:
    """Exact-cosine top-k over an integer vector database, int8-plane
    resident on ``device``.

    mode: 'exact' (the default) | 'approx' — the same exact selection in
    the port (see the module docstring)."""

    def __init__(self, vectors: np.ndarray, chunk_rows: int = 262144,
                 mode: str = "exact", recall_target: float = 0.95,
                 pool_margin: int = 64, *, device):
        V = np.asarray(vectors)
        if V.dtype not in (np.int8, np.int16, np.int32):
            raise ValueError("IntExactIndex requires integer vectors; "
                             f"got {V.dtype}")
        n, d = V.shape
        R = int(min(chunk_rows, max(1, n)))
        max_abs = 0
        for s in range(0, n, R):
            blk = V[s:s + R]
            if blk.size:
                max_abs = max(max_abs, int(blk.max()), -int(blk.min()))
        pm.check_exact_dot_range(d, max(1, max_abs))
        self._setup(resolve_device(device), (n, d), R, max_abs, mode,
                    recall_target, pool_margin)
        self.ns = np.empty(n, dtype=np.int64)
        for c in range(self._stack.shape[0]):
            s, e = c * R, min((c + 1) * R, n)
            block = np.ascontiguousarray(V[s:e], dtype=np.int32)
            b64 = block.astype(np.int64)
            self.ns[s:e] = np.einsum("ij,ij->i", b64, b64)  # exact |v|^2
            self._stage(c, torch.from_numpy(block).to(self.device))
        self._finish_norms()

    # -- construction --------------------------------------------------------
    def _setup(self, dev, shape, R, max_abs, mode, recall_target,
               pool_margin=64, L=None):
        """Attributes and a zero plane stack; L defaults to the limbs
        max_abs needs."""
        assert mode in ("exact", "approx"), mode
        self.device = dev
        self._shape = tuple(shape)
        self.chunk_rows = R
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = int(pool_margin)
        self.max_abs = max_abs
        self.L = pm.pick_limbs(max(1, max_abs)) if L is None else L
        n = self._shape[0]
        self._stack = self._plane_stack((n + R - 1) // R, dev)

    def _plane_stack(self, chunks: int, dev) -> torch.Tensor:
        """A zero (chunks, P, R_pad, d_pad) int8 plane stack on dev."""
        return torch.zeros((chunks, pm.num_planes(self.L),
                            pw.pad_rows(self.chunk_rows, dev),
                            pw.pad_dim(self.d)), dtype=torch.int8, device=dev)

    def _stage(self, c: int, block: torch.Tensor, stack=None) -> None:
        """Write one chunk's planes ((rows, d) int32 on the stack's device)
        into chunk c of ``stack`` (default: the index's own), in place."""
        stack = self._stack if stack is None else stack
        pw.planes_update(stack[c], pw.decompose_limbs(block, self.L), 0)

    def _finish_norms(self) -> None:
        C, _, R_pad, _ = self._stack.shape
        self._inv_n = torch.from_numpy(_inv_norms(
            self.ns, C, self.chunk_rows, R_pad, self.ntotal)).to(self.device)

    @classmethod
    def from_dbfolder(cls, db_folder: str, chunk_rows: int = 262144,
                      mode: str = "exact", recall_target: float = 0.95, *,
                      device) -> "IntExactIndex":
        """Stage the db folder's vectors.bin straight into the plane stack
        (memory-mapped host reads on a prefetch thread, planes decomposed on
        the device; device peak = stack + one chunk). The exact |v|^2 norms
        are recomputed from the data (int64)."""
        n, d, max_abs, R, C, ns, chunks = _dbfolder_staging(db_folder,
                                                            chunk_rows)
        self = cls.__new__(cls)
        self._setup(resolve_device(device), (n, d), R, max_abs, mode,
                    recall_target)
        for c, block in chunks:
            self._stage(c, torch.from_numpy(block).to(self.device))
        self.ns = ns
        self._finish_norms()
        return self

    @classmethod
    def from_device_chunks(cls, chunks, d: int, mode: str = "exact",
                           recall_target: float = 0.95) -> "IntExactIndex":
        """Build from device-resident integer chunks [(base_row, (rows, d)
        tensor), ...], uniform and contiguous (base_i == i * R, only the
        last may be shorter), all on one device. Planes are decomposed on
        the device and the exact |v|^2 computed there in int64. The chunk
        list is CONSUMED (emptied) so each chunk can free as staging
        proceeds."""
        assert chunks, "empty chunk list"
        R = int(chunks[0][1].shape[0])
        n = sum(int(c.shape[0]) for _, c in chunks)
        assert all(int(c.shape[0]) == R for _, c in chunks[:-1]) \
            and int(chunks[-1][1].shape[0]) <= R \
            and all(int(b) == i * R for i, (b, _) in enumerate(chunks)), \
            "device chunks must be uniform and contiguous"
        dev = chunks[0][1].device
        max_abs = 0
        for _, c in chunks:
            lo, hi = torch.aminmax(c)
            max_abs = max(max_abs, int(hi), -int(lo))
        pm.check_exact_dot_range(d, max(1, max_abs))
        self = cls.__new__(cls)
        self._setup(resolve_device(dev), (n, d), R, max_abs, mode,
                    recall_target)
        ns = torch.empty(n, dtype=torch.int64, device=dev)
        c = 0
        while chunks:
            base, chunk = chunks.pop(0)
            chunk = chunk.to(torch.int32)
            ns[base:base + chunk.shape[0]] = _exact_norms(chunk)
            self._stage(c, chunk)
            del chunk
            c += 1
        self.ns = ns.cpu().numpy()
        self._finish_norms()
        return self

    @property
    def ntotal(self) -> int:
        return self._shape[0]

    @property
    def d(self) -> int:
        return self._shape[1]

    # -- search --------------------------------------------------------------
    def pool_for(self, k: int) -> int:
        """Candidate pool size: k plus a margin absorbing the f32 device
        ranking error at the selection boundary (grows k/8 for very deep
        adaptive levels)."""
        return min(k + max(self.pool_margin, k >> 3), max(1, self.ntotal))

    def _pool(self, qp: torch.Tensor, B: int, pool: int, flag):
        """Device candidate pooling of the first B rows of the query planes
        qp -> (scores, indices, partials), see :func:`_int_scan_pool`."""
        bases, valid = chunk_layout(self._stack.shape[0], self.chunk_rows,
                                    self.ntotal)
        return _int_scan_pool(qp, B, self._stack, self._inv_n, self.ntotal,
                              self.chunk_rows, pool, self.L, flag, bases,
                              valid)

    def validate_queries(self, queries: np.ndarray) -> None:
        """Query-range check (search() and the adaptive search's int8
        route): integer dtype, components within the L-limb range this
        index was decomposed for."""
        Q = np.asarray(queries)
        if Q.dtype not in (np.int8, np.int16, np.int32, np.int64):
            raise ValueError("IntExactIndex takes integer query "
                             f"vectors; got {Q.dtype}")
        qmax = int(np.max(np.abs(Q.astype(np.int64)))) if Q.size else 0
        if not pm._limbs_ok(max(1, qmax), self.L):
            raise ValueError(
                f"query |component| {qmax} exceeds the L={self.L} limb "
                f"range this index was built for (db max_abs="
                f"{self.max_abs}); use the FlatIPIndex f32 path")

    def search(self, queries: np.ndarray, k: int):
        """queries: (B, d) INTEGER vectors (projected query sketches).
        -> (D (B, k) float32 exact-float64 cosines, I (B, k) int32);
        missing slots are (0, -1) like FAISS when k > ntotal."""
        Q = np.asarray(queries)
        B = Q.shape[0]
        if self.ntotal == 0:
            if Q.dtype not in (np.int8, np.int16, np.int32, np.int64):
                raise ValueError("IntExactIndex takes integer query "
                                 f"vectors; got {Q.dtype}")
            return (np.zeros((B, k), np.float32),
                    np.full((B, k), -1, np.int32))
        self.validate_queries(Q)
        k_eff = min(k, self.ntotal)
        pool = self.pool_for(k_eff)
        LAST_SEARCH_STAGES.clear()
        t0 = time.perf_counter()
        qp = query_planes(Q, self.L, self.device)
        LAST_SEARCH_STAGES["prep_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        flag = pw.range_flag(self.device)
        _, i_dev, p_dev = self._pool(qp, B, pool, flag)
        LAST_SEARCH_STAGES["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        idx = i_dev.cpu().numpy()                      # (B, pool_eff)
        parts = p_dev.cpu().numpy()                    # (B, pool_eff, P)
        pw.check_range_flag(flag)
        LAST_SEARCH_STAGES["device_d2h_ms"] = \
            (time.perf_counter() - t0) * 1e3
        LAST_SEARCH_STAGES["d2h_bytes"] = idx.nbytes + parts.nbytes
        t0 = time.perf_counter()
        W = idx.shape[1]
        dots = pm.combine_plane_partials(
            parts.reshape(-1, parts.shape[2]).T, self.L).reshape(B, W)
        qns = np.einsum("ij,ij->i", Q.astype(np.int64), Q.astype(np.int64))
        denom = np.sqrt(self.ns[np.maximum(idx, 0)].astype(np.float64)
                        * qns[:, None].astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.where(denom > 0, dots / np.maximum(denom, 1e-300),
                             0.0)
        score = np.where(idx >= 0, score, -np.inf)
        # one batched lexsort: query-major, then exact score desc, then
        # lowest index (the FAISS tie order); invalid entries carry -inf so
        # each row's valid hits form a prefix of its order
        rows = np.repeat(np.arange(B), W)
        order = np.lexsort((idx.ravel(), -score.ravel(), rows))
        cols = (order % W).reshape(B, W)[:, :k_eff]
        top_i = np.take_along_axis(idx, cols, axis=1)
        top_s = np.take_along_axis(score, cols, axis=1)
        valid = top_i >= 0
        D = np.zeros((B, k), dtype=np.float32)
        I = np.full((B, k), -1, dtype=np.int32)
        I[:, :k_eff] = np.where(valid, top_i, -1)
        D[:, :k_eff] = np.where(valid, top_s, 0.0).astype(np.float32)
        LAST_SEARCH_STAGES["finalize_ms"] = (time.perf_counter() - t0) * 1e3
        return D, I
