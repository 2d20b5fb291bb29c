"""read_pc_mat: Python query frontend (reference: src/read_pc_mat.py) over
the query engine — prints top-10 neighbors per query or a pandas DataFrame
for row/col sliced queries."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


class PC_Matrix:
    """API-compatible with the reference's PC_Matrix (read_pc_mat.py:11-44)."""

    @staticmethod
    def query_ava_matrix(matrix_folder, db_folder, query_file):
        from ..query.engine import query_by_names
        t0 = time.perf_counter()
        results = query_by_names(matrix_folder, db_folder, query_file)
        print(f"Query completed in {time.perf_counter() - t0:.6f} seconds.\n")
        return [{"id": r["id"],
                 "neighbor_ids": np.array(r["neighbor_ids"]),
                 "jaccard_similarities": np.array(r["jaccard_similarities"])}
                for r in results]

    @staticmethod
    def query_pc_mat_sliced(matrix_folder, db_folder, row_file, col_file):
        from ..query.engine import query_sliced_by_names
        t0 = time.perf_counter()
        results = query_sliced_by_names(matrix_folder, db_folder, row_file, col_file)
        print(f"Query completed in {time.perf_counter() - t0:.6f} seconds.\n")
        return {"row_list": np.array(results["row-list"]),
                "col_list": np.array(results["col-list"]),
                "jac_dict": results["jac-dict"]}


def process_query_file(matrix_folder, db_folder, query_file):
    print(f"Processing query_file: {query_file} in {matrix_folder}")
    results = PC_Matrix.query_ava_matrix(matrix_folder, db_folder, query_file)
    for res in results:
        print(f"Query {res['id']}: #Neighbors = {len(res['neighbor_ids'])}")
        n = min(10, len(res["neighbor_ids"]))
        print(f"Top {n} neighbors:")
        print("Neighbor IDs:", res["neighbor_ids"][:n])
        print("Jaccard Similarities:", res["jaccard_similarities"][:n])
        print()


def process_row_col(matrix_folder, db_folder, row_file, col_file):
    print(f"Processing row_file: {row_file}, col_file: {col_file} in {matrix_folder}")
    results = PC_Matrix.query_pc_mat_sliced(matrix_folder, db_folder,
                                            row_file, col_file)
    import pandas as pd
    data = [results["jac_dict"][row] for row in results["row_list"]]
    df = pd.DataFrame(data, index=results["row_list"], columns=results["col_list"])
    print(df.to_string())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Pairwise Comparison Matrix Search")
    parser.add_argument("--matrix", required=True)
    parser.add_argument("--db", required=True)
    parser.add_argument("--query_file")
    parser.add_argument("--row_file")
    parser.add_argument("--col_file")
    args = parser.parse_args(argv)
    if args.query_file:
        if args.row_file or args.col_file:
            parser.error("Cannot combine --query_file with --row_file/--col_file")
        process_query_file(args.matrix, args.db, args.query_file)
    elif args.row_file and args.col_file:
        process_row_col(args.matrix, args.db, args.row_file, args.col_file)
    else:
        parser.error("Must provide either --query_file or both --row_file AND --col_file")
    return 0


if __name__ == "__main__":
    sys.exit(main())
