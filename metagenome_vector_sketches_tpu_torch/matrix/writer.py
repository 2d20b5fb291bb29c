"""Shard writer for the active jaccard_wo_sort matrix format.

Replicates the reference writer's math exactly
(write_sparse_results_jaccard_wo_sort, pairwise_comp_optimized.cpp:645-817):
J = (dot/d) / (|A| + |B| - dot/d) in float64 with text-parsed squared norms,
clamped to 1, quantized q = round(J*255) half-away-from-zero; self-pairs
included. Layout documented in FORMATS.md (rows written in ascending order —
a deliberate, documented divergence from the reference's unordered_map order,
whose own reader treats the index as authoritative).

The port's own writer: its files are byte-identical to the JAX package's
writer's for the same triples (tests/test_torch_standalone.py); only how it
reaches the (row asc, col asc) order differs (:func:`_row_major_order`).
"""

from __future__ import annotations

import os

import numpy as np

from .. import codecs
from ..utils.profiling import stage

MULT_CONST = 255.0  # (1 << 8) - 1, pairwise_comp_optimized.cpp:654
# ids below these pack into one non-negative int64 key row * 2**32 + col
KEY_ROWS = 1 << 31
KEY_COLS = 1 << 32


def quantize_jaccard(values: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                     norms_sq: np.ndarray, dimension: int) -> np.ndarray:
    """int64 raw dots -> uint16 quantized Jaccard, reference float64 math.

    jac is clamped to [0, 1]: a noisy estimate can push the intersection
    past |A|+|B| (negative/infinite jac), and a negative float -> uint16
    cast is undefined at the C level (the reference would hit the same UB;
    no defined behavior exists to match). For jac >= 0, floor(x + 0.5) IS
    round-half-away-from-zero, the documented invariant."""
    inter = values.astype(np.float64) / float(dimension)
    with np.errstate(divide="ignore", invalid="ignore"):
        jac = inter / (norms_sq[rows] + norms_sq[cols] - inter)
    jac = np.clip(np.nan_to_num(jac, nan=0.0), 0.0, 1.0)
    return np.floor(jac * MULT_CONST + 0.5).astype(np.uint16)


def _row_major_order(rows: np.ndarray, cols: np.ndarray):
    """The permutation ``np.lexsort((cols, rows))`` gives the int64 ids
    (row asc, col asc, stable), or None where they are already in that
    order (then the permutation is the identity).

    Ids in the packed range are one int64 key each: one O(n) pass finds
    the keys non-decreasing (>=, so equal pairs keep their order, as the
    stable lexsort keeps it), else a stable argsort of the keys gives the
    same permutation at a fraction of lexsort's cost. Other ids take
    lexsort."""
    if len(rows) == 0:
        return None
    if rows.min() < 0 or rows.max() >= KEY_ROWS or cols.min() < 0 \
            or cols.max() >= KEY_COLS:
        return np.lexsort((cols, rows))
    key = (rows << 32) | cols
    if np.all(key[1:] >= key[:-1]):
        return None
    return np.argsort(key, kind="stable")


def write_shard(folder: str, rows: np.ndarray, cols: np.ndarray,
                values: np.ndarray, norms_sq: np.ndarray, dimension: int,
                layout: str = "native", *, record: dict | None = None) -> None:
    """Write one shard folder from surviving (row, col, raw int64 dot) triples.

    norms_sq: float64 squared norms for ALL vectors (text-parsed then squared,
    reference pairwise_comp_optimized.cpp:893-901).

    layout: 'native' (FORMATS.md serialization) or 'bits' (the reconstructed
    jermp/bits layout, codecs.bitscompat — what real reference-built readers
    and server artifacts use). The shard reader autodetects either.

    record: where given, gets the walls of the write's three stages, each
    a span of its own: ``write_order_ms`` (the ordering, span
    ``mvs.write.order``), ``write_quantize_ms`` (the quantisation, span
    ``mvs.write.quantize``) and ``write_codec_ms`` (the row boundaries, the
    codecs and the three files, span ``mvs.write.codec``); and
    ``write_presorted`` (1 when the triples came in order and nothing was
    sorted, else 0).
    """
    if layout == "bits":
        from ..codecs import bitscompat as cdc
    else:
        cdc = codecs
    os.makedirs(folder, exist_ok=True)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)

    record = {} if record is None else record

    # deterministic (row asc, col asc) ordering
    with stage("mvs.write.order", record, "write_order_ms"):
        order = _row_major_order(rows, cols)
        if order is not None:
            rows, cols, values = rows[order], cols[order], values[order]
    record["write_presorted"] = int(order is None)
    with stage("mvs.write.quantize", record, "write_quantize_ms"):
        q = quantize_jaccard(values, rows, cols, norms_sq, dimension)
    with stage("mvs.write.codec", record, "write_codec_ms"):
        _write_files(folder, rows, cols, q, cdc, layout)


def _write_files(folder: str, rows: np.ndarray, cols: np.ndarray,
                 q: np.ndarray, cdc, layout: str) -> None:
    """The shard's three files from its ordered triples' rows, columns and
    quantised values (``cdc``: the layout's codec module)."""
    # each row's first triple: np.unique(rows, return_index=True) on the
    # sorted rows, without its sort
    first = np.ones(len(rows), dtype=bool)
    np.not_equal(rows[1:], rows[:-1], out=first[1:])
    start_idx = np.flatnonzero(first)
    unique_rows = rows[start_idx]
    boundaries = np.append(start_idx, len(rows))

    body = None
    if layout == "native" and codecs.have_native():
        # batched native build: one C++ call for the whole shard body
        # (byte-identical with the per-row loop below)
        from ..codecs import native as _native
        body = _native.write_matrix_rows(cols.astype(np.uint64),
                                         q.astype(np.uint64),
                                         boundaries.astype(np.uint64))
    if body is not None:
        blob_all, positions, start_neighbor = body
        with open(os.path.join(folder, "matrix.bin"), "wb") as bin_out:
            bin_out.write(blob_all)
    else:
        positions = np.zeros(len(unique_rows), dtype=np.uint64)
        start_neighbor = np.zeros(len(unique_rows), dtype=np.uint64)
        pos = 0
        with open(os.path.join(folder, "matrix.bin"), "wb") as bin_out:
            for k, row in enumerate(unique_rows):
                s, e = boundaries[k], boundaries[k + 1]
                row_cols = cols[s:e]
                row_q = q[s:e]
                positions[k] = pos
                start_neighbor[k] = row_cols[0]
                blob = cdc.cv_encode(row_q.astype(np.uint64))
                if len(row_cols) > 1:
                    deltas = np.diff(row_cols).astype(np.uint64)
                    assert np.all(deltas > 0), \
                        "columns must be strictly increasing"
                    blob += cdc.rice_encode(deltas)
                bin_out.write(blob)
                pos += len(blob)

    with open(os.path.join(folder, "row_index.bin"), "wb") as index_out:
        index_out.write(cdc.cv_encode(unique_rows.astype(np.uint64)))
        pos_deltas = np.diff(positions) if len(positions) > 1 else \
            np.empty(0, dtype=np.uint64)
        index_out.write(cdc.cv_encode(pos_deltas.astype(np.uint64)))

    with open(os.path.join(folder, "neighbor_start.bin"), "wb") as ngh_out:
        ngh_out.write(cdc.rice_encode(start_neighbor))
