"""Sparse-matrix export (the reference's convert_to_zarr.cpp — not built in
its own tree — writes a COO {row, col, data} int32 group). Here: COO export
to .npz always, and to a Zarr group when the zarr package is available.
"""

from __future__ import annotations

import numpy as np

from ..matrix.reader import MatrixReader


def matrix_to_coo(matrix_folder: str, total_vectors: int):
    """Active-format matrix -> (row, col, data) int32 COO arrays; data is the
    quantized Jaccard (q/255 to dequantize)."""
    reader = MatrixReader(matrix_folder)
    r, c, q = reader.decode_all_triples(total_vectors)
    return r.astype(np.int32), c.astype(np.int32), q.astype(np.int32)


def export_npz(matrix_folder: str, total_vectors: int, out_path: str) -> str:
    r, c, d = matrix_to_coo(matrix_folder, total_vectors)
    np.savez_compressed(out_path, row=r, col=c, data=d)
    # savez_compressed appends '.npz' when the suffix is missing — return
    # the path of the file actually written, not the argument
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    return out_path


def export_zarr(matrix_folder: str, total_vectors: int, out_path: str,
                chunk: int = 1 << 20) -> str:
    try:
        import zarr
    except ImportError as e:
        raise RuntimeError("zarr is not installed; use export_npz") from e
    r, c, d = matrix_to_coo(matrix_folder, total_vectors)
    root = zarr.open_group(out_path, mode="w")
    root.create_dataset("row", data=r, chunks=(chunk,))
    root.create_dataset("col", data=c, chunks=(chunk,))
    root.create_dataset("data", data=d, chunks=(chunk,))
    return out_path
