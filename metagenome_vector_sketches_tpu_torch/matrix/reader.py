"""Shard reader for the active matrix format.

Mirrors the reference reader stack (read_pc_mat_cmp.cpp): shard discovery by
`shard_K` directory regex (:96-113), static row->shard mapping (:117-120),
row-index decode with delta-coded addresses (:145-175), and per-row decode of
quantized Jaccards + delta-coded neighbor columns (:597-671).
"""

from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass

import numpy as np

from .. import codecs
from ..codecs import bitscompat

_SHARD_RE = re.compile(r"shard_(\d+)$")


# (cv_decode, rice_decode) per codec layout — the single shared adapter
# (codecs.bitscompat.decoders) so reader/legacy/detect rules cannot diverge
_decoders = bitscompat.decoders


def discover_shards(matrix_folder: str) -> int:
    """Number of shards = max shard index + 1 (read_pc_mat_cmp.cpp:96-113)."""
    max_shard = -1
    for entry in os.listdir(matrix_folder):
        if os.path.isdir(os.path.join(matrix_folder, entry)):
            m = _SHARD_RE.fullmatch(entry)
            if m:
                max_shard = max(max_shard, int(m.group(1)))
    return max_shard + 1


def get_shard_for_row(row: int, total_vectors: int, num_shards: int) -> int:
    if num_shards <= 0:
        raise FileNotFoundError(
            "no shard_K directories found in the matrix folder — wrong "
            "path, or the matrix has not been computed yet")
    rows_per_shard = (total_vectors + num_shards - 1) // num_shards
    return row // rows_per_shard


@dataclass
class ShardIndex:
    """Decoded row_index.bin + neighbor_start.bin of one shard."""
    rows: np.ndarray          # row ids in written order
    addresses: np.ndarray     # absolute byte offsets into matrix.bin
    start_neighbor: np.ndarray  # first neighbor column per row (written order)
    row_to_pos: dict          # row id -> position in written order
    fmt: str = "native"       # codec layout ('native' | 'bits')


def load_shard_index(shard_folder: str) -> ShardIndex | None:
    index_path = os.path.join(shard_folder, "row_index.bin")
    ngh_path = os.path.join(shard_folder, "neighbor_start.bin")
    if not (os.path.exists(index_path) and os.path.exists(ngh_path)):
        return None
    with open(index_path, "rb") as f:
        blob = f.read()
    # layout autodetect: real server shards were written by jermp/bits;
    # ours by the FORMATS.md serialization (shared logic:
    # codecs.bitscompat.detect_two; the active format's extra invariant is
    # n rows + n-1 position deltas)
    fmt, rows, deltas = bitscompat.detect_two(
        blob, "cv", validate=lambda r, d: len(d) == max(0, len(r) - 1))
    _, rice_dec = _decoders(fmt)
    addresses = np.zeros(len(rows), dtype=np.uint64)
    if len(rows) > 1:
        addresses[1:] = np.cumsum(deltas.astype(np.uint64))
    with open(ngh_path, "rb") as f:
        start_neighbor, _ = rice_dec(f.read(), 0)
    return ShardIndex(rows=rows.astype(np.int64), addresses=addresses,
                      start_neighbor=start_neighbor.astype(np.int64),
                      row_to_pos={int(r): i for i, r in enumerate(rows)},
                      fmt=fmt)


class ShardReader:
    """Random-access row decode over one shard's matrix.bin."""

    def __init__(self, shard_folder: str):
        self.folder = shard_folder
        self.index = load_shard_index(shard_folder)
        self._blob = None

    # above this size matrix.bin is memory-mapped instead of snapshotted
    # (zero-copy decodes work against either); small/typical shards keep the
    # read() snapshot so flaky-NFS faults stay retryable OSErrors rather
    # than page-fault SIGBUS, and a concurrent rewrite can't mutate a
    # cached reader's view
    MMAP_THRESHOLD = 64 << 20

    @property
    def blob(self):
        if self._blob is None:
            path = os.path.join(self.folder, "matrix.bin")
            # retry-open against flaky shared filesystems (the reference's
            # 5 x 50 ms loop, read_pc_mat_cmp.cpp:471-476); ValueError covers
            # np.memmap on a concurrently-truncated file
            last_err = None
            for _ in range(5):
                try:
                    size = os.path.getsize(path)
                    if size == 0:
                        self._blob = np.empty(0, dtype=np.uint8)
                    elif size >= self.MMAP_THRESHOLD:
                        self._blob = np.memmap(path, dtype=np.uint8, mode="r")
                    else:
                        with open(path, "rb") as f:
                            self._blob = f.read()
                    break
                except (OSError, ValueError) as e:
                    last_err = e
                    time.sleep(0.05)
            else:
                raise last_err
        return self._blob

    def decode_row(self, row: int):
        """-> (neighbor_cols int64 array, quantized_jaccards uint64 array)
        or None if the row has no entry in this shard."""
        if self.index is None:
            return None
        pos = self.index.row_to_pos.get(int(row))
        if pos is None:
            return None
        addr = int(self.index.addresses[pos])
        cv_dec, rice_dec = _decoders(self.index.fmt)
        q, consumed = cv_dec(self.blob, addr)
        n = len(q)
        if n == 0:
            # a written row always has >= 1 neighbor (its self-pair at
            # minimum) — reject like the hardened native batched decoder
            # instead of IndexError on cols[0]
            raise ValueError(f"corrupt matrix row {int(row)}: zero-size "
                             "neighbor vector")
        cols = np.empty(n, dtype=np.int64)
        cols[0] = self.index.start_neighbor[pos]
        if n > 1:
            deltas, _ = rice_dec(self.blob, addr + consumed)
            cols[1:] = cols[0] + np.cumsum(deltas.astype(np.int64))
        return cols, q

    def decode_rows_batch(self, rows):
        """Batched decode aligned with `rows`: list of (cols, q) or None.
        One native call for the whole batch on native-layout shards
        (mvs_read_matrix_rows); per-row fallback otherwise."""
        if self.index is None:
            return [None] * len(rows)
        pos_list = [self.index.row_to_pos.get(int(r)) for r in rows]
        present = [i for i, p in enumerate(pos_list) if p is not None]
        results = [None] * len(rows)
        if not present:
            return results
        batch = None
        if self.index.fmt == "native" and codecs.have_native():
            from ..codecs import native as _native
            addrs = self.index.addresses[[pos_list[i] for i in present]]
            firsts = self.index.start_neighbor[[pos_list[i] for i in present]]
            batch = _native.read_matrix_rows(
                self.blob, addrs.astype(np.uint64),
                firsts.astype(np.uint64))
        if batch is not None:
            cols, q, bounds = batch
            for j, i in enumerate(present):
                s, e = int(bounds[j]), int(bounds[j + 1])
                results[i] = (cols[s:e].astype(np.int64), q[s:e])
        else:
            for i in present:
                results[i] = self.decode_row(int(rows[i]))
        return results


class MatrixReader:
    """Multi-shard reader with per-shard caching (the query stack's engine)."""

    def __init__(self, matrix_folder: str):
        self.matrix_folder = matrix_folder
        self.num_shards = discover_shards(matrix_folder)
        self._shards: dict[int, ShardReader] = {}

    def shard(self, idx: int) -> ShardReader:
        if idx not in self._shards:
            self._shards[idx] = ShardReader(
                os.path.join(self.matrix_folder, f"shard_{idx}"))
        return self._shards[idx]

    def load_neighbors_for_rows(self, rows, total_vectors: int):
        """Batched per-shard row decode
        (load_neighbors_for_rows_jaccard_wo_sort, read_pc_mat_cmp.cpp:597-671).
        Returns a list aligned with `rows`: (cols, q) or None."""
        results = [None] * len(rows)
        by_shard: dict[int, list[int]] = {}
        for i, row in enumerate(rows):
            by_shard.setdefault(
                get_shard_for_row(int(row), total_vectors, self.num_shards), []).append(i)
        for shard_idx, query_idxs in by_shard.items():
            reader = self.shard(shard_idx)
            decoded = reader.decode_rows_batch([int(rows[qi])
                                                for qi in query_idxs])
            for qi, dec in zip(query_idxs, decoded):
                results[qi] = dec
        return results

    def decode_all_triples(self, total_vectors: int):
        """Decode every (row, col, q) triple across all shards — the
        conformance/parity view of the whole matrix."""
        rows_out, cols_out, q_out = [], [], []
        for s in range(self.num_shards):
            reader = self.shard(s)
            if reader.index is None:
                continue
            decoded = reader.decode_rows_batch(reader.index.rows.tolist())
            for row, dec in zip(reader.index.rows, decoded):
                cols, q = dec
                rows_out.append(np.full(len(cols), row, dtype=np.int64))
                cols_out.append(cols)
                q_out.append(q.astype(np.int64))
        if not rows_out:
            empty = np.empty(0, dtype=np.int64)
            return empty, empty.copy(), empty.copy()
        return (np.concatenate(rows_out), np.concatenate(cols_out),
                np.concatenate(q_out))
