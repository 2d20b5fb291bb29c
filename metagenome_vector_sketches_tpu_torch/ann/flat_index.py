"""Flat inner-product index: exact top-k over L2-normalised float32 vectors.

Port of ``metagenome_vector_sketches_tpu/ann/flat_index.py`` (the FAISS
IndexFlatIP of the reference's jaccard.py). Search streams the database
chunk by chunk: a float32 matrix product of the queries with the chunk,
then kernel K (``ann.select``): the chunk's top-k and its merge into the
running top-k (exact, lowest index first among equal scores, as
``jax.lax.top_k``). The products are plain
``torch.matmul`` in true float32: TF32 is switched off for the call
(:func:`fp32_matmul`), because TF32 scores are ~1e-3 off and break FAISS
parity.

precision 'bf16_rescore' scores with bfloat16-rounded operands (products
exact, float32 sums — the JAX engine's bf16 matmul with a float32 result)
over a 4k-wide candidate pool, then rescores the pool exactly in float32.

The index file is ``faiss.index`` in the db folder, written in the genuine
FAISS IndexFlatIP serialisation by the shared ``faissio`` (byte-identical
to the JAX package's); the older private "MVSFLATIP" format still loads.
"""

from __future__ import annotations

import contextlib
import os
import struct
import time

import numpy as np
import torch

from .._device import resolve_device
from . import faissio
from ..io.dbfolder import DbFolder
from .select import (key_index, key_scores, rank_keys, select_chunk,
                     select_keys)

MAGIC = b"MVSFLATIP\x00"
VERSION = 1

# per-stage wall split of the LAST FlatIPIndex.search() call: dispatch_ms
# (enqueue of the chunk products and selections), device_d2h_ms (the
# device->host copy of (D, I), which waits for them), finalize_ms (host
# padding)
LAST_SEARCH_STAGES: dict = {}


def normalize_l2(x: np.ndarray) -> np.ndarray:
    """faiss.normalize_L2 semantics: float32 row normalisation; zero rows
    stay zero. numpy, the same ops as the JAX package's, so the index file
    is byte-identical."""
    x = x.astype(np.float32, copy=True)
    norms = np.sqrt(np.einsum("ij,ij->i", x, x, dtype=np.float32))
    nz = norms > 0
    x[nz] /= norms[nz, None]
    return x


@contextlib.contextmanager
def fp32_matmul():
    """float32 matrix products in true float32 (no TF32) inside the block;
    the caller's settings come back after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def _assert_fp32() -> None:
    assert not torch.backends.cuda.matmul.allow_tf32 \
        and torch.get_float32_matmul_precision() == "highest", \
        "float32 matmul must not use TF32 on this path"


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16-rounded values, held in float32 (so products are exact and
    sums float32)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _scan_topk(queries: torch.Tensor, chunks, n_total: int, k: int,
               precision: str = "f32"):
    """Whole-index top-k: (B, d) float32 queries over [(base, (rows, d))]
    chunks -> (scores (B, kk), indices (B, kk) int64), kk = min(k, rows
    in the chunks). precision 'bf16' rounds both operands to bfloat16."""
    _assert_fp32()
    q = _bf16(queries) if precision == "bf16" else queries
    kk = min(k, sum(int(c.shape[0]) for _, c in chunks))
    best = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for base, chunk in chunks:
        x = _bf16(chunk) if precision == "bf16" else chunk.float()
        rows = x.shape[0]
        scores = q @ x.T                                # (B, rows)
        if base + rows > n_total:       # rows past n_total score -inf
            lane = torch.arange(rows, device=q.device)
            scores = scores.masked_fill(lane[None, :] >= n_total - base,
                                        float("-inf"))
        # kernel K: every lane keeps its index base + lane
        _, _, best, _ = select_chunk(scores, base, rows, 0, min(kk, rows),
                                     best, kk)
    return key_scores(best), key_index(best)


def _rescore_exact(queries: torch.Tensor, flat: torch.Tensor,
                   cand_i: torch.Tensor, n_total: int, k: int):
    """Exact float32 rescoring of a candidate set: gather the candidate
    rows of ``flat`` ((rows, d), float32 or bfloat16), recompute the inner
    products, top-k among them (ties: the earlier candidate first)."""
    _assert_fp32()
    gathered = flat[cand_i.clamp(min=0)].float()        # (B, kc, d)
    scores = torch.einsum("bd,bkd->bk", queries, gathered)
    scores = scores.masked_fill((cand_i < 0) | (cand_i >= n_total),
                                float("-inf"))
    pos = torch.arange(cand_i.shape[1], device=cand_i.device)
    keys, _ = select_keys(rank_keys(scores, pos), k)
    return key_scores(keys), torch.gather(cand_i, 1, key_index(keys))


class FlatIPIndex:
    """Exact inner-product top-k over L2-normalised vectors on ``device``.

    recall_target is kept for the interface (the JAX engine's approx_max_k
    below 1.0); the port selects exactly."""

    def __init__(self, vectors: np.ndarray, chunk_rows: int = 65536,
                 recall_target: float = 1.0, precision: str = "f32", *,
                 device):
        """vectors: (n, d) float32, already normalised. precision: 'f32'
        (FAISS-exact scores, the parity default) | 'bf16_rescore'."""
        assert precision in ("f32", "bf16_rescore"), precision
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.device = resolve_device(device)
        self.chunk_rows = chunk_rows
        self.recall_target = float(recall_target)
        self.precision = precision
        self._shape = self.vectors.shape
        self._flat = None      # (n, d) device rows, when one tensor holds all
        self._chunks = None    # [(base, (rows, d) device tensor)]

    @classmethod
    def from_device_chunks(cls, chunks, d: int, recall_target: float = 1.0,
                           store: str | None = None) -> "FlatIPIndex":
        """Build an index over device-resident normalised float32 chunks
        [(base_row, (rows, d) tensor), ...] on one device (no host copy;
        save() is unavailable).

        store='bf16' re-stores the index as one bfloat16 tensor, casting
        chunk by chunk and freeing each float32 original: the PASSED LIST
        IS CONSUMED (the caller must hold no other references for the
        originals to free). Search is then bf16_rescore over the bfloat16
        store: exact inner products of the bf16-rounded vectors."""
        dev = chunks[0][1].device
        self = cls(np.empty((0, d), dtype=np.float32),
                   recall_target=recall_target,
                   precision="bf16_rescore" if store == "bf16" else "f32",
                   device=dev)
        n = sum(int(c.shape[0]) for _, c in chunks)
        self._shape = (n, d)
        if store == "bf16":
            R = int(chunks[0][1].shape[0])
            assert all(int(b) == i * R for i, (b, _) in enumerate(chunks)) \
                and all(int(c.shape[0]) == R for _, c in chunks[:-1]), \
                "bf16 store requires uniform contiguous chunks"
            cast = []
            while chunks:
                _, c = chunks.pop(0)
                cast.append(c.to(torch.bfloat16))
                del c                                   # free the original
            self._flat = torch.cat(cast)
            del cast
            self._chunks = [(s, self._flat[s:s + R]) for s in range(0, n, R)]
        else:
            self._chunks = list(chunks)
        return self

    @property
    def ntotal(self) -> int:
        return self._shape[0]

    @property
    def d(self) -> int:
        return self._shape[1]

    def _chunk_list(self):
        """[(base, (rows, d) device tensor)]; a host-built index uploads its
        vectors once, as one tensor viewed in chunk_rows chunks."""
        if self._chunks is None:
            n = self.ntotal
            self._flat = torch.from_numpy(self.vectors).to(self.device)
            self._chunks = [(s, self._flat[s:s + self.chunk_rows])
                            for s in range(0, n, self.chunk_rows)]
        return self._chunks

    def _rows(self) -> torch.Tensor:
        """All rows as one (n, d) device tensor (the rescore's gather)."""
        self._chunk_list()
        if self._flat is None:
            raise ValueError(
                "bf16_rescore needs the rows in one tensor: build a device "
                "index with from_device_chunks(..., store='bf16')")
        return self._flat

    def search_device(self, queries_dev: torch.Tensor, k: int):
        """(B, d) float32 normalised queries on the index's device ->
        (D, I) device tensors at k_eff = min(k, ntotal) (I int64)."""
        k_eff = min(k, max(1, self.ntotal))
        with fp32_matmul():
            if self.precision == "bf16_rescore":
                kc = min(max(4 * k_eff, 64), self.ntotal)
                _, cand = _scan_topk(queries_dev, self._chunk_list(),
                                     self.ntotal, kc, precision="bf16")
                return _rescore_exact(queries_dev, self._rows(), cand,
                                      self.ntotal, k_eff)
            return _scan_topk(queries_dev, self._chunk_list(), self.ntotal,
                              k_eff)

    def search(self, queries: np.ndarray, k: int):
        """-> (D (B,k) float32, I (B,k) int32); missing slots are (0, -1)
        like FAISS when k > ntotal."""
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
        k_eff = min(k, max(1, self.ntotal))
        if self.ntotal == 0:
            B = q.shape[0]
            return np.zeros((B, k), np.float32), np.full((B, k), -1,
                                                         np.int32)
        LAST_SEARCH_STAGES.clear()
        t0 = time.perf_counter()
        best_d, best_i = self.search_device(q.to(self.device), k)
        LAST_SEARCH_STAGES["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        D = best_d.cpu().numpy().copy()
        I = best_i.cpu().numpy().astype(np.int32)
        LAST_SEARCH_STAGES["device_d2h_ms"] = \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        D[I < 0] = 0.0
        if k_eff < k:
            D = np.pad(D, ((0, 0), (0, k - k_eff)))
            I = np.pad(I, ((0, 0), (0, k - k_eff)), constant_values=-1)
        LAST_SEARCH_STAGES["finalize_ms"] = (time.perf_counter() - t0) * 1e3
        return D, I

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """Write genuine FAISS IndexFlatIP bytes (the reference artifact,
        jaccard.py:59-61)."""
        if self.vectors.shape[0] != self.ntotal:
            raise ValueError("save() requires a host-resident index "
                             "(built from vectors, not device chunks)")
        faissio.write_flat(path, self.vectors,
                           metric=faissio.METRIC_INNER_PRODUCT)

    @staticmethod
    def load(path: str, chunk_rows: int = 65536, *,
             device) -> "FlatIPIndex":
        """Load a genuine FAISS IndexFlat file (inner-product metric only)
        or the older private MVSFLATIP format — autodetected by magic."""
        with open(path, "rb") as f:
            head = f.read(len(MAGIC))
        if faissio.is_faiss_flat(head):
            data, metric = faissio.read_flat(path)
            if metric != faissio.METRIC_INNER_PRODUCT:
                raise ValueError(
                    f"{path}: FAISS metric_type {metric} is not "
                    "inner-product; this serving path requires an "
                    "IndexFlatIP (the reference artifact)")
            return FlatIPIndex(data, chunk_rows=chunk_rows, device=device)
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise ValueError(f"{path}: neither a FAISS IndexFlat nor an "
                                 "MVS flat index")
            (version,) = struct.unpack("<I", f.read(4))
            if version != VERSION:
                raise ValueError(f"{path}: unsupported index version {version}")
            n, d = struct.unpack("<QQ", f.read(16))
            remaining = os.fstat(f.fileno()).st_size - f.tell()
            if d == 0 or n * d * 4 > remaining:
                raise ValueError(
                    f"{path}: header claims {n}x{d} float32 "
                    f"({n * d * 4} B) but only {remaining} B remain — "
                    "corrupt index")
            data = np.fromfile(f, dtype=np.float32, count=n * d).reshape(n, d)
        return FlatIPIndex(data, chunk_rows=chunk_rows, device=device)


def index_vectors(db_folder: str, verbose: bool = True) -> str:
    """Build faiss.index from a db folder (reference jaccard.py:18-61: int
    vectors -> float32 -> normalize_L2 -> IndexFlatIP -> write). Host work
    only: the file is byte-identical to the JAX package's."""
    db = DbFolder(db_folder)
    vectors = normalize_l2(db.load_vectors())
    out = os.path.join(db_folder, "faiss.index")
    faissio.write_flat(out, vectors, metric=faissio.METRIC_INNER_PRODUCT)
    if verbose:
        print(f"Indexed {vectors.shape[0]} vectors of dimension "
              f"{vectors.shape[1]} into {out}.")
    return out
