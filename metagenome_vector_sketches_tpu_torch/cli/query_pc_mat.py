"""query_pc_mat: top-k neighbor queries and row/col sliced sub-matrix queries
over a pairwise matrix (reference CLI: src/query_pc_mat.cpp:242-366).

Same flags and output rules: regular queries write one `<ID>_<outfile>` file
per query (csv/tsv/txt); sliced queries write csv/tsv/npy/npz. Queries
decode the shard files on the host: nothing here runs on the device.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="query_pc_mat",
                                description="Query Pairwise Comparison Matrix")
    p.add_argument("--matrix", help="Folder containing the pairwise matrix files")
    p.add_argument("--db", help="Folder containing the matrix meta data")
    p.add_argument("--query_file", help="File containing query IDs (one per line)")
    p.add_argument("--query_ids", nargs="+",
                   help="Query IDs as command line arguments")
    p.add_argument("--row_file", help="File containing query row IDs")
    p.add_argument("--col_file", help="File containing query col IDs")
    p.add_argument("--top", type=int, default=10, dest="top_n")
    p.add_argument("--batch_size", type=int, default=1000)
    p.add_argument("--write_to_file", default=None, metavar="FILE")
    p.add_argument("--show_all", action="store_true")
    p.add_argument("--print", action="store_true", dest="print_to_screen")
    return p


def _err(msg: str):
    print(msg, file=sys.stderr)
    print("Aborting...", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> int:
    from ..io.dbfolder import DbFolder
    from ..query import engine
    from ..query.outputs import (get_file_extension, sep_for_extension,
                                 write_topk_result, SlicedWriter, format_float)
    from ..utils.log import human_time

    args = build_parser().parse_args(argv)
    if not args.matrix:
        _err("Error: matrix folder is required.")
    if not args.db:
        _err("Error: db folder is required.")
    use_query = bool(args.query_file or args.query_ids)
    use_slice = bool(args.row_file)
    if not use_query and not use_slice:
        _err("No query files given.")
    write_to_file = args.write_to_file is not None
    out_fn = args.write_to_file or "out.txt"
    print_to_screen = args.print_to_screen or not write_to_file

    db = DbFolder(args.db)
    identifiers, norms = db.names_and_norms_f32()
    id_to_index = db.id_to_index()
    total = len(identifiers)
    print(f"Total vectors loaded: {total}\n")

    if use_query:
        ext = get_file_extension(out_fn)
        if write_to_file and ext not in ("csv", "tsv", "txt"):
            _err(f"Output file extension is: {ext}. Expected: csv, tsv or txt.")
        sep = sep_for_extension(ext)
        if args.query_file:
            queries, _ = engine.read_queries_from_file(args.query_file, id_to_index)
        else:
            queries = [i for i in
                       (engine.parse_query_to_index(s, id_to_index)
                        for s in args.query_ids) if i >= 0]
        if not queries:
            _err("Error: No valid queries found")
        elapsed = 0.0
        for start in range(0, len(queries), args.batch_size):
            batch = queries[start:start + args.batch_size]
            t0 = time.perf_counter()
            results = engine.query(args.matrix, batch, norms, identifiers)
            elapsed += time.perf_counter() - t0
            for res in results:
                if print_to_screen:
                    print(f"Query: {res.self_id} #Neighbors: {len(res.neighbor_ids)}")
                n = len(res.neighbor_ids) if args.show_all else \
                    min(args.top_n, len(res.neighbor_ids))
                if write_to_file and res.self_id:
                    path = write_topk_result(res, out_fn, sep, args.top_n,
                                             args.show_all)
                    print(f"Writing in file: {path}\n")
                if print_to_screen:
                    print(f"Top {n} neighbors:")
                    for j in range(n):
                        print(f"{j+1}. Neighbor: {res.neighbor_ids[j]} "
                              f"Jaccard Similarity: "
                              f"{format_float(res.jaccard_similarities[j])}")
                    print()
            t, unit = human_time(elapsed)
            print(f"--------- Completed\t{min(start + args.batch_size, len(queries))}"
                  f"\tqueries in\t{t:.2f}\t{unit} ---------")
        t, unit = human_time(elapsed)
        print(f"Query completed in {t:.2f}\t{unit}\n")
    else:
        if not args.row_file or not args.col_file:
            _err("Either row or col file is not specified.")
        ext = get_file_extension(out_fn)
        if write_to_file and ext not in ("csv", "tsv", "npy", "npz"):
            _err(f"Output file extension is: {ext}. Expected: csv, tsv, npy or npz.")
        sep = sep_for_extension(ext) if ext in ("csv", "tsv") else "-1"
        row_q, row_ids = engine.read_queries_from_file(args.row_file, id_to_index)
        col_q, col_ids = engine.read_queries_from_file(args.col_file, id_to_index)
        if not row_q or not col_q:
            _err("Empty row or col accessions.")
        writer = SlicedWriter(out_fn, col_ids, sep) if write_to_file else None
        if print_to_screen:
            print("Accession\t" + "\t".join(col_ids))
        elapsed = 0.0
        for start in range(0, len(row_q), args.batch_size):
            batch = row_q[start:start + args.batch_size]
            t0 = time.perf_counter()
            mat = engine.query_sliced(args.matrix, batch, col_q, total, norms)
            elapsed += time.perf_counter() - t0
            for i in range(len(batch)):
                rid = row_ids[start + i]
                if print_to_screen:
                    print(rid + "\t" + "\t".join(format_float(v) for v in mat[i]))
                if writer:
                    writer.write_row(rid, mat[i])
            t, unit = human_time(elapsed)
            print(f"--------- Completed\t{min(start + args.batch_size, len(row_q))}"
                  f"\trows in\t{t:.2f}\t{unit} ---------")
        if writer:
            writer.close()
        t, unit = human_time(elapsed)
        print(f"Query completed in {t:.2f}\t{unit}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
