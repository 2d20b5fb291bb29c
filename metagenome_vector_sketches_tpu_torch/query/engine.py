"""Query engine over the matrix artifacts.

Replicates pc_mat::query and pc_mat::query_sliced
(read_pc_mat_cmp.cpp:989-1046, 1136-1171): decode requested rows, sort
neighbors by quantized Jaccard descending (we use a stable sort so ties keep
ascending-column order — the reference's std::sort is unstable, making its
tie order unspecified; this is the documented deterministic choice), and
dequantize J = q/255 to float32.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..io.dbfolder import DbFolder
from ..matrix.reader import MatrixReader

MULT_CONST = 255.0


@dataclass
class Result:
    self_id: str = ""
    neighbor_ids: list = field(default_factory=list)
    jaccard_similarities: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.float32))


def parse_query_to_index(query_str: str, id_to_index: dict) -> int:
    """Numeric strings are raw indices (unvalidated at parse time, like
    read_pc_mat_cmp.cpp:673-689); otherwise an identifier lookup; -1 if
    unknown.

    Matches C++ std::stoi semantics, not python int(): a numeric PREFIX
    parses ("42abc" -> row 42), and an out-of-int-range number throws (->
    identifier lookup path), where int() would do the opposite on both."""
    m = re.match(r"\s*[+-]?\d+", query_str)
    if m:
        v = int(m.group())
        if -2**31 <= v <= 2**31 - 1:       # stoi raises out_of_range beyond
            return v
    return id_to_index.get(query_str, -1)


def read_queries_from_file(path: str, id_to_index: dict):
    """-> (indices, id_strings); skips empties/comments
    (read_pc_mat_cmp.cpp:692-722)."""
    queries, ids = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            idx = parse_query_to_index(line, id_to_index)
            if idx >= 0:
                queries.append(idx)
                ids.append(line)
    return queries, ids


# process-level MatrixReader reuse across query batches: the CLI's batch
# loop calls query() once per batch, and a fresh reader would re-parse
# every shard's row_index.bin/neighbor_start.bin each time. Keyed on the
# folder's mtime too, so a rebuilt matrix (shard dirs added/removed)
# invalidates.
_READER_CACHE: dict = {}


def _reader(matrix_folder: str) -> MatrixReader:
    try:
        key = (os.path.abspath(matrix_folder),
               os.stat(matrix_folder).st_mtime_ns)
    except OSError:
        return MatrixReader(matrix_folder)
    r = _READER_CACHE.get(key)
    if r is None:
        if len(_READER_CACHE) >= 8:
            _READER_CACHE.clear()
        r = _READER_CACHE[key] = MatrixReader(matrix_folder)
    return r


def query(matrix_folder: str, queries, vector_norms: np.ndarray,
          identifiers: list[str]) -> list[Result]:
    """Top-neighbor query for a batch of row indices."""
    total = len(vector_norms)
    reader = _reader(matrix_folder)
    decoded = reader.load_neighbors_for_rows(queries, total)
    results = []
    for qrow, dec in zip(queries, decoded):
        if qrow < 0 or qrow >= total:
            results.append(Result())
            continue
        if dec is None:
            results.append(Result())
            continue
        cols, q = dec
        order = np.argsort(-q.astype(np.int64), kind="stable")
        cols, q = cols[order], q[order]
        res = Result(self_id=identifiers[qrow])
        res.neighbor_ids = [identifiers[c] if 0 <= c < total else "UNKNOWN"
                            for c in cols]
        res.jaccard_similarities = (q.astype(np.float64) / MULT_CONST).astype(np.float32)
        results.append(res)
    return results


def query_sliced(matrix_folder: str, row_queries, col_queries,
                 total_vectors: int, vector_norms: np.ndarray) -> np.ndarray:
    """Sliced sub-matrix: (len(rows), len(cols)) float32, 0 for absent pairs
    (load_neighbors_for_slice + query_sliced, read_pc_mat_cmp.cpp:1048-1171)."""
    reader = _reader(matrix_folder)
    decoded = reader.load_neighbors_for_rows(row_queries, total_vectors)
    cols_arr = np.asarray(col_queries, dtype=np.int64)
    out = np.zeros((len(row_queries), len(cols_arr)), dtype=np.float32)
    for i, dec in enumerate(decoded):
        if dec is None:
            continue
        cols, q = dec
        if len(cols) == 0:
            continue  # a written row always retains its self pair, but the
            # searchsorted guard below would index [-1] on an empty decode
        # decoded neighbor columns are ascending (delta prefix sums), so the
        # requested columns resolve with one searchsorted instead of a
        # python dict probe per cell
        pos = np.searchsorted(cols, cols_arr)
        safe = np.minimum(pos, len(cols) - 1)
        valid = (pos < len(cols)) & (cols[safe] == cols_arr)
        vals = np.where(valid, q[safe].astype(np.float64), 0.0)
        out[i] = (vals / MULT_CONST).astype(np.float32)
    return out


def query_by_names(matrix_folder: str, db_folder: str, query_file: str):
    """bindings.cpp:query_py equivalent — the Python-API entry
    (returns list of dicts with numpy arrays)."""
    db = DbFolder(db_folder)
    identifiers, norms = db.names_and_norms_f32()
    queries, _ = read_queries_from_file(query_file, db.id_to_index())
    results = query(matrix_folder, queries, norms, identifiers)
    return [{"id": r.self_id,
             "neighbor_ids": np.array(r.neighbor_ids),
             "jaccard_similarities": r.jaccard_similarities}
            for r in results]


def query_sliced_by_names(matrix_folder: str, db_folder: str,
                          row_file: str, col_file: str):
    """bindings.cpp:query_sliced_py equivalent."""
    db = DbFolder(db_folder)
    identifiers, norms = db.names_and_norms_f32()
    id_to_index = db.id_to_index()
    row_q, row_ids = read_queries_from_file(row_file, id_to_index)
    col_q, col_ids = read_queries_from_file(col_file, id_to_index)
    mat = query_sliced(matrix_folder, row_q, col_q, len(identifiers), norms)
    return {"row-list": row_ids, "col-list": col_ids,
            "jac-dict": {rid: mat[i].tolist() for i, rid in enumerate(row_ids)}}
