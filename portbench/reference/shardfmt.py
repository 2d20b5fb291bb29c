"""Frozen decoder of the matrix shard folder (the serialization that the
repository's FORMATS.md sets out), in plain numpy.

A shard folder holds ``row_index.bin`` (a compact vector of the rows, then a
compact vector of the byte-offset deltas of each row's record in
``matrix.bin``), ``neighbor_start.bin`` (a rice sequence of each row's first
neighbour column) and ``matrix.bin`` (per row: a compact vector of the
quantised Jaccards, then, for rows of more than one neighbour, a rice
sequence of the column deltas). All integers are little-endian; bit 0 of
word 0 is the first bit of a stream.

This is the benchmark's own copy: it imports nothing of the program.
"""

from __future__ import annotations

import os

import numpy as np

_U64 = np.uint64


def _u64s(buf, offset: int, count: int) -> np.ndarray:
    return np.frombuffer(buf, dtype="<u8", count=count, offset=offset)


def _unpack_fixed(words: np.ndarray, n: int, width: int) -> np.ndarray:
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    w = np.concatenate([words.astype(np.uint64), np.zeros(1, np.uint64)])
    starts = np.arange(n, dtype=np.uint64) * _U64(width)
    widx = (starts >> _U64(6)).astype(np.int64)
    shift = starts & _U64(63)
    lo = w[widx] >> shift
    rs = (_U64(64) - shift) & _U64(63)
    hi = np.where(shift == 0, _U64(0), w[widx + 1] << rs)
    mask = _U64(0xFFFFFFFFFFFFFFFF) if width == 64 else \
        (_U64(1) << _U64(width)) - _U64(1)
    return (lo | hi) & mask


def cv_decode(buf, offset: int = 0) -> tuple[np.ndarray, int]:
    """compact vector ``size | width | num_words | words`` -> (values,
    bytes consumed)."""
    n, width, nw = (int(x) for x in _u64s(buf, offset, 3))
    if not 1 <= width <= 64 or n * width > nw * 64:
        raise ValueError("corrupt compact-vector header")
    return _unpack_fixed(_u64s(buf, offset + 24, nw), n, width), 24 + 8 * nw


def rice_decode(buf, offset: int = 0) -> tuple[np.ndarray, int]:
    """rice sequence ``size | l | num_words | words`` (each value: v >> l
    one-bits, a zero bit, the l low bits) -> (values, bytes consumed).
    Terminators are found without a walk over the bits: over the indices
    of the zero bits, g[k] is the first zero at or past zeros[k] + 1 + l,
    and the orbit of g from the first zero is filled by pointer doubling."""
    n, l, nw = (int(x) for x in _u64s(buf, offset, 3))
    if l > 63 or n * (1 + l) > nw * 64:
        raise ValueError("corrupt rice header")
    words = _u64s(buf, offset + 24, nw)
    used = 24 + 8 * nw
    if n == 0:
        return np.empty(0, dtype=np.uint64), used
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    inv = bits == 0
    zeros = np.flatnonzero(inv).astype(np.int64)
    if len(zeros) < n:
        raise ValueError("corrupt rice stream: missing terminators")
    if l == 0:
        z = np.arange(n, dtype=np.int64)
    else:
        zc = np.cumsum(inv, dtype=np.int64)
        g = zc[np.minimum(zeros + l, len(zc) - 1)]
        np.minimum(g, len(zeros) - 1, out=g)
        z = np.empty(n, dtype=np.int64)
        z[0] = 0
        step, G = 1, g
        while step < n:
            take = min(step, n - step)
            z[step:step + take] = G[z[:take]]
            G = G[G]
            step *= 2
    zpos = zeros[z]
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    starts[1:] = zpos[:-1] + 1 + l
    q = (zpos - starts).astype(np.uint64)
    if l:
        rpos = (zpos + 1).astype(np.uint64)
        w = np.concatenate([words.astype(np.uint64), np.zeros(1, np.uint64)])
        widx = (rpos >> _U64(6)).astype(np.int64)
        shift = rpos & _U64(63)
        lo = w[widx] >> shift
        rs = (_U64(64) - shift) & _U64(63)
        hi = np.where(shift == 0, _U64(0),
                      w[np.minimum(widx + 1, len(w) - 1)] << rs)
        rem = (lo | hi) & ((_U64(1) << _U64(l)) - _U64(1))
    else:
        rem = _U64(0)
    return (q << _U64(l)) | rem, used


class Shard:
    """One written shard folder, opened for row lookups."""

    def __init__(self, folder: str):
        with open(os.path.join(folder, "row_index.bin"), "rb") as f:
            idx = f.read()
        rows, used = cv_decode(idx, 0)
        deltas, _ = cv_decode(idx, used)
        if len(deltas) != max(0, len(rows) - 1):
            raise ValueError(f"{folder}: row index holds {len(rows)} rows "
                             f"and {len(deltas)} offset deltas")
        with open(os.path.join(folder, "neighbor_start.bin"), "rb") as f:
            first, _ = rice_decode(f.read(), 0)
        if len(first) != len(rows):
            raise ValueError(f"{folder}: {len(first)} first neighbours for "
                             f"{len(rows)} rows")
        with open(os.path.join(folder, "matrix.bin"), "rb") as f:
            self.blob = f.read()
        self.rows = rows.astype(np.int64)
        self.addresses = np.zeros(len(rows), dtype=np.int64)
        if len(rows) > 1:
            self.addresses[1:] = np.cumsum(deltas.astype(np.int64))
        self.first = first.astype(np.int64)
        self.pos = {int(r): i for i, r in enumerate(self.rows)}

    def row(self, r: int):
        """-> (columns int64, quantised Jaccards int64) of row r, or empty
        arrays when the shard holds no record of r."""
        i = self.pos.get(int(r))
        if i is None:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy()
        addr = int(self.addresses[i])
        q, used = cv_decode(self.blob, addr)
        cols = np.empty(len(q), dtype=np.int64)
        if len(q) == 0:
            raise ValueError(f"row {r}: a record of no neighbours")
        cols[0] = self.first[i]
        if len(q) > 1:
            d, _ = rice_decode(self.blob, addr + used)
            if len(d) != len(q) - 1:
                raise ValueError(f"row {r}: {len(q)} values, {len(d)} "
                                 "column deltas")
            cols[1:] = cols[0] + np.cumsum(d.astype(np.int64))
        return cols, q.astype(np.int64)
