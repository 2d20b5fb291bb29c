"""Matrix interpretation utilities (reference src/interpret_pairwise_comp.py:
pure-python decode of a legacy matrix, per-row Jaccard print, neighbor-count
histogram). Works over both the active shard format and legacy format A.
"""

from __future__ import annotations

import sys

import numpy as np

from ..io.dbfolder import DbFolder
from ..matrix.reader import MatrixReader
from ..matrix.legacy import read_legacy_prev


def neighbor_count_histogram(matrix_folder: str, total_vectors: int):
    """-> (row ids, neighbor counts) over the active-format matrix."""
    reader = MatrixReader(matrix_folder)
    rows, counts = [], []
    for s in range(reader.num_shards):
        shard = reader.shard(s)
        if shard.index is None:
            continue
        for row in shard.index.rows:
            cols, _ = shard.decode_row(int(row))
            rows.append(int(row))
            counts.append(len(cols))
    return np.array(rows), np.array(counts)


def print_row_jaccards(matrix_folder: str, db_folder: str, row: int = 10,
                       legacy: bool = False):
    """Decode one row and print index/jaccard pairs (reference :59-85 prints
    row 10 of the legacy matrix with norms-based jaccard)."""
    db = DbFolder(db_folder)
    names, norms = db.names_and_norms()

    def name_of(c):
        # matrix/db mismatches print UNKNOWN (like query.engine) instead of
        # crashing the whole interpretation with an IndexError
        return names[c] if 0 <= c < len(names) else "UNKNOWN"

    if legacy:
        data = read_legacy_prev(matrix_folder)
        if row not in data or not (0 <= row < len(norms)):
            print(f"row {row} not found")
            return
        cols, vals = data[row]
        for c, v in zip(cols, vals):
            ni = norms[row] ** 2
            nj = norms[c] ** 2 if 0 <= c < len(norms) else 0.0
            jac = v / (ni + nj - v)
            print(f"{c} ({name_of(c)}) inter={v} jaccard={jac:.4f}")
    else:
        reader = MatrixReader(matrix_folder)
        res = reader.load_neighbors_for_rows([row], len(names))[0]
        if res is None:
            print(f"row {row} not found")
            return
        cols, q = res
        for c, qq in zip(cols, q):
            print(f"{c} ({name_of(c)}) jaccard={qq/255.0:.4f}")


def plot_histogram(matrix_folder: str, total_vectors: int, show: bool = True,
                   save: str | None = None):
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    _, counts = neighbor_count_histogram(matrix_folder, total_vectors)
    plt.figure(figsize=(8, 6))
    plt.hist(counts, bins=50)
    plt.xlabel("#neighbors per row")
    plt.ylabel("#rows")
    plt.title("Neighbor count histogram")
    if save:
        plt.savefig(save)
    if show:
        plt.show()
    plt.close()


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: interpret <matrix_folder> <db_folder> [row]")
        return 1
    row = int(argv[2]) if len(argv) > 2 else 10
    print_row_jaccards(argv[0], argv[1], row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
