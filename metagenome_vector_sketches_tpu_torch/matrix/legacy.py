"""Legacy matrix formats (read + write), for completeness with the
reference's historical artifacts (SURVEY.md §2.5):

Format A ("prev", raw int32): per row, first column absolute then deltas,
followed by per-neighbor values round(dot/d), 8 bytes per neighbor total;
row_index.txt lines "<row> <byte offset>"
(reference writer write_sparse_results_prev pairwise_comp_optimized.cpp:193-254,
readers read_pc_mat.cpp:148-272, interpret_pairwise_comp.py:19-57).

Format B ("ef+cv"): per row an elias_fano of columns then a compact_vector of
round(dot/d) values; row_index.bin = compact_vector(rows) +
compact_vector(absolute positions)
(reference writer write_sparse_results pairwise_comp_optimized.cpp:256-339,
reader read_pc_mat_cmp.cpp:123-143 + load_neighbors_for_rows :251-363; this
is also what the reference's int16 path emits, :426).

Codec serialization defaults to this framework's (FORMATS.md); the B/C/D
readers ALSO autodetect the reconstructed jermp/bits layout
(codecs.bitscompat) that genuine reference-built server artifacts use, and
the writers take layout="bits" to emit it. The reference compresses these
files with `zstd -f` shellouts and decompresses with `zstd -d` before every
read (read_pc_mat.cpp:10-13); our writers emit uncompressed files (use
:func:`compress_legacy_folder` to reproduce the as-left server state) and
every reader transparently accepts `<file>.zst` via the in-process
utils.zstdio — so historical artifacts (bits layout + zstd) are ingestible
exactly as found.
"""

from __future__ import annotations

import os

import numpy as np

from .. import codecs
from ..utils.zstdio import compress, read_maybe_zst


class _BitsFamily:
    """codec-call adapter over the reconstructed jermp/bits layout
    (codecs.bitscompat) with the same signatures as the package codecs."""
    @staticmethod
    def cv_encode(values):
        from ..codecs import bitscompat
        return bitscompat.cv_encode(np.asarray(values, dtype=np.uint64))

    @staticmethod
    def cv_decode(buf, offset=0):
        from ..codecs import bitscompat
        return bitscompat.decoders("bits")[0](buf, offset)

    @staticmethod
    def rice_encode(values):
        from ..codecs import bitscompat
        return bitscompat.rice_encode(np.asarray(values, dtype=np.uint64))

    @staticmethod
    def rice_decode(buf, offset=0):
        from ..codecs import bitscompat
        return bitscompat.rice_decode(buf, offset)

    @staticmethod
    def ef_encode(values, universe):
        from ..codecs import bitscompat
        return bitscompat.ef_encode(np.asarray(values, dtype=np.uint64),
                                    universe)

    @staticmethod
    def ef_decode(buf, offset=0):
        from ..codecs import bitscompat
        return bitscompat.ef_decode(buf, offset)


def _family(layout: str):
    return _BitsFamily if layout == "bits" else codecs


def _detect_two(blob: bytes, kind: str):
    """Autodetect the codec layout of a legacy row_index.bin (two
    concatenated blobs of `kind`). Real historical server artifacts are
    'bits'; ours are 'native'. Shared logic with the shard reader
    (codecs.bitscompat.detect_two). -> (layout, first, second)."""
    from ..codecs import bitscompat
    return bitscompat.detect_two(blob, kind)


def compress_legacy_folder(folder: str, level: int = 3) -> None:
    """Put a legacy folder into the reference's as-left state: every
    artifact file replaced by `<name>.zst` (the reference's `zstd -f`
    shellout, pairwise_comp_optimized.cpp:334-338)."""
    for name in sorted(os.listdir(folder)):
        full = os.path.join(folder, name)
        if name.endswith(".zst") or not os.path.isfile(full):
            continue
        with open(full, "rb") as f:
            data = f.read()
        with open(full + ".zst", "wb") as f:
            f.write(compress(data, level))
        os.remove(full)


def _group(rows, cols, values):
    order = np.lexsort((cols, rows))
    rows, cols, values = (np.asarray(a, dtype=np.int64)[order]
                          for a in (rows, cols, values))
    unique_rows, start = np.unique(rows, return_index=True)
    bounds = np.append(start, len(rows))
    return rows, cols, values, unique_rows, bounds


def round_half_away(x: np.ndarray) -> np.ndarray:
    """C++ round(): half away from zero (used for value quantization
    round(dot/d), pairwise_comp_optimized.cpp:243,286)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


# ---------------------------------------------------------------- format A
def write_legacy_prev(folder: str, rows, cols, values, dimension: int) -> None:
    os.makedirs(folder, exist_ok=True)
    rows, cols, values, unique_rows, bounds = _group(rows, cols, values)
    vals32 = round_half_away(values.astype(np.float64) / dimension).astype(np.int32)
    pos = 0
    with open(os.path.join(folder, "matrix.bin"), "wb") as bin_out, \
            open(os.path.join(folder, "row_index.txt"), "w") as index_out:
        for k, row in enumerate(unique_rows):
            s, e = bounds[k], bounds[k + 1]
            index_out.write(f"{row} {pos}\n")
            row_cols = cols[s:e].astype(np.int32)
            deltas = np.empty_like(row_cols)
            deltas[0] = row_cols[0]
            deltas[1:] = np.diff(row_cols)
            bin_out.write(deltas.astype("<i4").tobytes())
            bin_out.write(vals32[s:e].astype("<i4").tobytes())
            pos += 8 * len(row_cols)


def read_legacy_prev(folder: str):
    """-> dict row -> (cols int64, values int32)."""
    index = []
    for line in read_maybe_zst(os.path.join(folder, "row_index.txt")) \
            .decode().splitlines():
        parts = line.split()
        if len(parts) == 2:
            index.append((int(parts[0]), int(parts[1])))
    data = read_maybe_zst(os.path.join(folder, "matrix.bin"))
    size = len(data)
    out = {}
    for k, (row, pos) in enumerate(index):
        end = index[k + 1][1] if k + 1 < len(index) else size
        n = (end - pos) // 8
        deltas = np.frombuffer(data, dtype="<i4", count=n,
                               offset=pos).astype(np.int64)
        vals = np.frombuffer(data, dtype="<i4", count=n, offset=pos + 4 * n)
        out[row] = (np.cumsum(deltas), vals)
    return out


# ---------------------------------------------------------------- format B
def write_legacy_ef(folder: str, rows, cols, values, dimension: int,
                    layout: str = "native") -> None:
    fam = _family(layout)
    os.makedirs(folder, exist_ok=True)
    rows, cols, values, unique_rows, bounds = _group(rows, cols, values)
    vals = round_half_away(values.astype(np.float64) / dimension).astype(np.uint64)
    pos = 0
    positions = np.zeros(len(unique_rows), dtype=np.uint64)
    with open(os.path.join(folder, "matrix.bin"), "wb") as bin_out:
        for k, row in enumerate(unique_rows):
            s, e = bounds[k], bounds[k + 1]
            row_cols = cols[s:e].astype(np.uint64)
            positions[k] = pos
            blob = fam.ef_encode(row_cols, int(row_cols[-1]) + 1)
            blob += fam.cv_encode(vals[s:e])
            bin_out.write(blob)
            pos += len(blob)
    with open(os.path.join(folder, "row_index.bin"), "wb") as index_out:
        index_out.write(fam.cv_encode(unique_rows.astype(np.uint64)))
        index_out.write(fam.cv_encode(positions))


# ---------------------------------------------------------------- format C
def write_legacy_rice(folder: str, rows, cols, values, dimension: int,
                      layout: str = "native") -> None:
    """The 'rice-everything' historical variant (reference writer
    write_sparse_results_rice, pairwise_comp_optimized.cpp:341-476): per row
    a rice_sequence of delta columns then a rice_sequence of round(dot/d)
    values; row_index.bin = rice(rows) + rice(absolute positions);
    neighbor_start.bin = rice(first columns)."""
    fam = _family(layout)
    os.makedirs(folder, exist_ok=True)
    rows, cols, values, unique_rows, bounds = _group(rows, cols, values)
    vals = round_half_away(values.astype(np.float64) / dimension).astype(np.uint64)
    positions = np.zeros(len(unique_rows), dtype=np.uint64)
    start_neighbor = np.zeros(len(unique_rows), dtype=np.uint64)
    pos = 0
    with open(os.path.join(folder, "matrix.bin"), "wb") as bin_out:
        for k, row in enumerate(unique_rows):
            s, e = bounds[k], bounds[k + 1]
            row_cols = cols[s:e]
            positions[k] = pos
            start_neighbor[k] = row_cols[0]
            deltas = np.diff(row_cols).astype(np.uint64)
            blob = fam.rice_encode(deltas)
            blob += fam.rice_encode(vals[s:e])
            bin_out.write(blob)
            pos += len(blob)
    with open(os.path.join(folder, "row_index.bin"), "wb") as f:
        f.write(fam.rice_encode(unique_rows.astype(np.uint64)))
        f.write(fam.rice_encode(positions))
    with open(os.path.join(folder, "neighbor_start.bin"), "wb") as f:
        f.write(fam.rice_encode(start_neighbor))


def read_legacy_rice(folder: str):
    """-> dict row -> (cols int64, values int64) (reference reader
    load_neighbors_for_rows_rice, read_pc_mat_cmp.cpp:373-514)."""
    blob = read_maybe_zst(os.path.join(folder, "row_index.bin"))
    layout, rows, positions = _detect_two(blob, "rice")
    fam = _family(layout)
    starts, _ = fam.rice_decode(
        read_maybe_zst(os.path.join(folder, "neighbor_start.bin")), 0)
    data = read_maybe_zst(os.path.join(folder, "matrix.bin"))
    out = {}
    for k, (row, pos) in enumerate(zip(rows.astype(np.int64),
                                       positions.astype(np.int64))):
        deltas, used = fam.rice_decode(data, int(pos))
        vals, _ = fam.rice_decode(data, int(pos) + used)
        if len(vals) == 0:
            # a written row always has >= 1 neighbor — a zero-size values
            # vector is corrupt content (match the hardened native-path
            # error, not an IndexError on cols[0])
            raise ValueError(f"corrupt legacy rice row {int(row)}: "
                             "zero-size values vector")
        cols = np.empty(len(vals), dtype=np.int64)
        cols[0] = starts[k]
        if len(vals) > 1:
            cols[1:] = cols[0] + np.cumsum(deltas.astype(np.int64))
        out[int(row)] = (cols, vals.astype(np.int64))
    return out


# ---------------------------------------------------------------- format D
def write_legacy_sorted(folder: str, rows, cols, dots, norms_sq,
                        dimension: int, layout: str = "native") -> None:
    """The sorted-by-jaccard uint16 historical variant (reference writer
    write_sparse_results_jaccard, pairwise_comp_optimized.cpp:479-643; its
    reader is commented out upstream, read_pc_mat_cmp.cpp:516-595): self
    pairs dropped, J = (dot/d)/(|A|+|B|-dot/d) clamped to 1 and quantized
    round(J*65535); per row, neighbors sorted by quantized J DESCENDING
    (ties broken by ascending column — the reference's std::sort is
    unstable), stored as raw uint16 top value + rice_sequence of descending
    deltas + compact_vector of neighbor columns in that order;
    row_index.bin = compact_vector(rows) + compact_vector(position deltas,
    first position implicitly 0). The reference zstd-compresses both files
    via shellout; we write uncompressed like the other legacy writers."""
    fam = _family(layout)
    os.makedirs(folder, exist_ok=True)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    dots = np.asarray(dots, dtype=np.int64)
    norms_sq = np.asarray(norms_sq, dtype=np.float64)
    keep = rows != cols
    rows, cols, dots = rows[keep], cols[keep], dots[keep]
    inter = dots.astype(np.float64) / dimension
    jac = np.minimum(inter / (norms_sq[rows] + norms_sq[cols] - inter), 1.0)
    q = round_half_away(jac * 65535.0).astype(np.uint64)

    order = np.lexsort((cols, rows))
    rows, cols, q = rows[order], cols[order], q[order]
    unique_rows, start = np.unique(rows, return_index=True)
    bounds = np.append(start, len(rows))

    positions = np.zeros(len(unique_rows), dtype=np.uint64)
    pos = 0
    with open(os.path.join(folder, "matrix.bin"), "wb") as bin_out:
        for k in range(len(unique_rows)):
            s, e = bounds[k], bounds[k + 1]
            # jaccard-desc, column-asc tiebreak (input is column-sorted and
            # the mergesort kind is stable)
            srt = np.argsort(-q[s:e].astype(np.int64), kind="stable")
            rq = q[s:e][srt]
            rc = cols[s:e][srt].astype(np.uint64)
            positions[k] = pos
            blob = int(rq[0]).to_bytes(2, "little")
            blob += fam.rice_encode((rq[:-1] - rq[1:]).astype(np.uint64))
            blob += fam.cv_encode(rc)
            bin_out.write(blob)
            pos += len(blob)
    with open(os.path.join(folder, "row_index.bin"), "wb") as f:
        f.write(fam.cv_encode(unique_rows.astype(np.uint64)))
        f.write(fam.cv_encode(np.diff(positions).astype(np.uint64)))


def read_legacy_sorted(folder: str):
    """-> dict row -> (cols int64 in jaccard-desc order, q uint16-as-int64
    quantized jaccards; dequantize J ~ q/65535)."""
    blob = read_maybe_zst(os.path.join(folder, "row_index.bin"))
    layout, rows, pdeltas = _detect_two(blob, "cv")
    fam = _family(layout)
    positions = np.zeros(len(rows), dtype=np.int64)
    if len(rows) > 1:
        positions[1:] = np.cumsum(pdeltas.astype(np.int64))
    data = read_maybe_zst(os.path.join(folder, "matrix.bin"))
    out = {}
    for row, pos in zip(rows.astype(np.int64), positions):
        pos = int(pos)
        top = int.from_bytes(data[pos:pos + 2], "little")
        deltas, used = fam.rice_decode(data, pos + 2)
        cols, _ = fam.cv_decode(data, pos + 2 + used)
        q = np.empty(len(cols), dtype=np.int64)
        q[0] = top
        if len(cols) > 1:
            q[1:] = top - np.cumsum(deltas.astype(np.int64))
        out[int(row)] = (cols.astype(np.int64), q)
    return out


def read_legacy_ef(folder: str):
    """-> dict row -> (cols int64, values int64)."""
    blob = read_maybe_zst(os.path.join(folder, "row_index.bin"))
    layout, rows, positions = _detect_two(blob, "cv")
    fam = _family(layout)
    data = read_maybe_zst(os.path.join(folder, "matrix.bin"))
    out = {}
    for row, pos in zip(rows.astype(np.int64), positions.astype(np.int64)):
        cols, used = fam.ef_decode(data, int(pos))
        vals, _ = fam.cv_decode(data, int(pos) + used)
        out[int(row)] = (cols.astype(np.int64), vals.astype(np.int64))
    return out
