"""Drop-in replacement for the reference's pybind11 module
`read_pc_mat_module` (reference src/bindings.cpp:110-126) over the port's
own query engine: query(matrix_folder, db_folder, query_file) and
query_sliced(matrix_folder, db_folder, row_file, col_file) with the same
return structures (list of dicts with numpy arrays / dict with
row-list/col-list/jac-dict), so code written against the reference works
with `from metagenome_vector_sketches_tpu_torch import read_pc_mat_module
as rpc`. The queries are host work: the shard was written by the device
engine, reading it needs no device.
"""

from .query.engine import (
    query_by_names as _query_by_names,
    query_sliced_by_names as _query_sliced_by_names,
)


def query(matrix_folder: str, db_folder: str, query_file: str):
    """Compute neighbors for queries; returns a list of dictionaries with
    neighbor IDs and jaccard similarities (reference bindings.cpp:46-70)."""
    return _query_by_names(matrix_folder, db_folder, query_file)


def query_sliced(matrix_folder: str, db_folder: str, row_file: str,
                 col_file: str):
    """Sliced sub-matrix query; returns a dict with row/col IDs and their
    jaccard similarities (reference bindings.cpp:72-108)."""
    return _query_sliced_by_names(matrix_folder, db_folder, row_file, col_file)
