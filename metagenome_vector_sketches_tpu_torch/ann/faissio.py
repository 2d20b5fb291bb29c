"""Genuine FAISS ``IndexFlat`` file-format interop.

The reference's db-folder contract includes a real FAISS-serialized
IndexFlatIP: ``faiss.write_index(index, "faiss.index")`` at
/root/reference/src/jaccard.py:59-61, read back with ``faiss.read_index``
at jaccard.py:120-124. This module reads and writes those exact bytes so

* a db folder produced by the reference (or any server artifact) loads
  directly into :class:`..ann.flat_index.FlatIPIndex`, and
* an index built by this framework is inspectable with stock FAISS tooling
  (``faiss.read_index`` accepts our output byte-for-byte).

Layout (faiss/impl/index_write.cpp, stable across FAISS releases — the
IndexFlatCodes refactor in 1.7 deliberately kept the on-disk format by
writing ``codes.size()/4`` as the element count):

    u32  fourcc   "IxFI" (METRIC_INNER_PRODUCT) | "IxF2" (L2) | "IxFl"
    i32  d
    i64  ntotal
    i64  dummy = 1<<20          (two legacy fields, always 1048576)
    i64  dummy = 1<<20
    u8   is_trained
    i32  metric_type            (0 = inner product, 1 = L2)
    [f32 metric_arg  iff metric_type > 1]
    u64  count = ntotal * d
    f32  data[count]            (row-major vectors)

Everything little-endian.
"""

from __future__ import annotations

import struct

import numpy as np

FOURCC_IP = b"IxFI"
FOURCC_L2 = b"IxF2"
FOURCC_GENERIC = b"IxFl"
_FLAT_FOURCCS = (FOURCC_IP, FOURCC_L2, FOURCC_GENERIC)

METRIC_INNER_PRODUCT = 0
METRIC_L2 = 1

_DUMMY = 1 << 20


def is_faiss_flat(head: bytes) -> bool:
    """True when the first 4+ bytes look like a FAISS IndexFlat file."""
    return head[:4] in _FLAT_FOURCCS


def write_flat(path: str, vectors: np.ndarray,
               metric: int = METRIC_INNER_PRODUCT) -> None:
    """Serialize (n, d) float32 vectors as ``faiss.write_index`` would an
    IndexFlatIP/IndexFlatL2 built over them (byte-identical output)."""
    vectors = np.ascontiguousarray(vectors, dtype="<f4")
    n, d = vectors.shape
    fourcc = FOURCC_IP if metric == METRIC_INNER_PRODUCT else \
        FOURCC_L2 if metric == METRIC_L2 else FOURCC_GENERIC
    with open(path, "wb") as f:
        f.write(fourcc)
        f.write(struct.pack("<i", d))
        f.write(struct.pack("<q", n))
        f.write(struct.pack("<qq", _DUMMY, _DUMMY))
        f.write(struct.pack("<B", 1))          # is_trained: flat always is
        f.write(struct.pack("<i", metric))
        if metric > 1:
            f.write(struct.pack("<f", 0.0))    # metric_arg
        f.write(struct.pack("<Q", n * d))
        vectors.tofile(f)


def read_flat(path: str) -> tuple[np.ndarray, int]:
    """Parse a FAISS IndexFlat* file -> ((n, d) float32 vectors, metric).

    Raises ValueError for non-flat FAISS indexes (informative message — the
    reference only ever writes IndexFlatIP) and for structural corruption.
    """
    with open(path, "rb") as f:
        fourcc = f.read(4)
        if fourcc not in _FLAT_FOURCCS:
            raise ValueError(
                f"{path}: not a FAISS IndexFlat file (fourcc {fourcc!r}); "
                "only flat indexes are supported — the reference pipeline "
                "writes IndexFlatIP (jaccard.py:59-61)")
        header = f.read(4 + 8 + 8 + 8 + 1 + 4)
        if len(header) != 33:
            raise ValueError(f"{path}: truncated FAISS header")
        d, ntotal, d1, d2, is_trained, metric = \
            struct.unpack("<iqqqBi", header)
        if d <= 0 or ntotal < 0 or d1 != _DUMMY or d2 != _DUMMY:
            raise ValueError(f"{path}: corrupt FAISS IndexFlat header")
        if metric > 1:
            if len(f.read(4)) != 4:            # metric_arg, unused
                raise ValueError(f"{path}: truncated FAISS header")
        count_raw = f.read(8)
        if len(count_raw) != 8:
            raise ValueError(f"{path}: truncated FAISS header")
        (count,) = struct.unpack("<Q", count_raw)
        if count != ntotal * d:
            raise ValueError(
                f"{path}: FAISS vector count {count} != ntotal*d "
                f"({ntotal}*{d})")
        # cap the allocation against the bytes actually present BEFORE
        # np.fromfile (which pre-allocates count*4 regardless of file size)
        # — same untrusted-header rule as the native codec decoders
        import os
        remaining = os.fstat(f.fileno()).st_size - f.tell()
        if count * 4 > remaining:
            raise ValueError(
                f"{path}: FAISS header claims {count} floats but only "
                f"{remaining} bytes remain — truncated or corrupt")
        data = np.fromfile(f, dtype="<f4", count=count)
        if data.size != count:
            raise ValueError(f"{path}: truncated FAISS vector data")
    return data.reshape(ntotal, d), metric
