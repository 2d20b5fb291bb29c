"""Row-appendable .npy writer with cnpy semantics.

The reference's sliced query appends one row at a time to a .npy via
cnpy::npy_save(..., "w"/"a") (query_pc_mat.cpp:207-212): the first write
creates a (1, C) array, later writes append raw data and patch the header
shape. We buffer rows and rewrite the header on close — same resulting file,
loadable by np.load.
"""

from __future__ import annotations

import numpy as np


class NpyAppender:
    def __init__(self, path: str, dtype=np.float32):
        self.path = path
        self.dtype = np.dtype(dtype)
        self._rows = 0
        self._cols = None
        self._f = None
        self._closed = False

    def append(self, row: np.ndarray) -> None:
        if self._closed:
            # reopening would truncate the file while _rows still counts
            # the previous rows — the final header would then claim rows
            # whose bytes are gone
            raise ValueError("append() after close()")
        row = np.ascontiguousarray(row, dtype=self.dtype)
        if self._f is None:
            self._cols = row.shape[-1]
            self._f = open(self.path, "w+b")
            self._write_header()
        assert row.shape[-1] == self._cols
        self._f.seek(0, 2)
        self._f.write(row.tobytes())
        self._rows += row.size // self._cols

    _HEADER_LEN = 118  # fixed so the shape can be patched in place (total 128)

    def _write_header(self) -> None:
        dt = self.dtype.str
        shape = f"({self._rows}, {self._cols})"
        header = f"{{'descr': '{dt}', 'fortran_order': False, 'shape': {shape}, }}"
        assert len(header) < self._HEADER_LEN
        header = header + " " * (self._HEADER_LEN - len(header) - 1) + "\n"
        self._f.seek(0)
        self._f.write(b"\x93NUMPY\x01\x00")
        self._f.write(np.uint16(self._HEADER_LEN).tobytes())
        self._f.write(header.encode("latin1"))

    def close(self) -> None:
        if self._f is not None:
            self._write_header()
            self._f.close()
            self._f = None
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
