"""query_ava_matrix: standalone reader for the LEGACY raw-int32 matrix format
(reference src/query_ava_matrix.cpp — its historical query tool over the
'prev' format with row_index.txt). Queries rows, sorts neighbors by the
norms-based Jaccard descending, prints/report like the modern tool.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="query_ava_matrix")
    p.add_argument("--matrix_folder", "--matrix", dest="matrix", required=True,
                   help="Legacy matrix folder (matrix.bin + row_index.txt)")
    # the reference reads vector_norms.txt from the matrix folder itself
    # (query_ava_matrix.cpp:529-532 load_vector_identifiers(matrix_folder));
    # --db points elsewhere when the norms live in a separate db folder
    p.add_argument("--db", default=None,
                   help="db folder with vector_norms.txt "
                        "(default: the matrix folder, as the reference)")
    p.add_argument("--query_file")
    p.add_argument("--query_ids", nargs="+")
    p.add_argument("--stdin", action="store_true", dest="read_stdin",
                   help="Read query IDs from standard input")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    from ..io.dbfolder import DbFolder
    from ..matrix.legacy import read_legacy_prev
    from ..query.engine import parse_query_to_index, read_queries_from_file

    db = DbFolder(args.db if args.db is not None else args.matrix)
    identifiers, norms = db.names_and_norms_f32()
    print(f"Total vectors loaded: {len(identifiers)}")
    id_to_index = db.id_to_index()
    if args.read_stdin:
        queries = [i for i in (parse_query_to_index(line.strip(), id_to_index)
                               for line in sys.stdin if line.strip())
                   if i >= 0]
    elif args.query_file:
        queries, _ = read_queries_from_file(args.query_file, id_to_index)
    elif args.query_ids:
        queries = [i for i in (parse_query_to_index(s, id_to_index)
                               for s in args.query_ids) if i >= 0]
    else:
        print("No queries specified", file=sys.stderr)
        return 1

    data = read_legacy_prev(args.matrix)
    for q in queries:
        # a raw numeric query id can exceed the norms file (engine.query
        # guards this for the modern tool; do the same here)
        qname = identifiers[q] if 0 <= q < len(identifiers) else "UNKNOWN"
        print(f"Query: {q} ({qname})")
        if q not in data or not (0 <= q < len(norms)):
            print("  No neighbors found")
            continue
        cols, vals = data[q]
        # sort by jaccard = inter / (|A| + |B| - inter), norms squared;
        # out-of-range neighbor columns (matrix built from a larger db
        # than the norms file) get |B| = 0 and still print as UNKNOWN
        # below instead of crashing the whole query run
        na = float(norms[q]) ** 2
        nb = np.array([float(norms[c]) ** 2 if c < len(norms) else 0.0
                       for c in cols])
        jac = np.array([v / (na + b - v) for b, v in zip(nb, vals)])
        order = np.argsort(-jac, kind="stable")
        for rank in order[:args.top]:
            c = int(cols[rank])
            nid = identifiers[c] if c < len(identifiers) else "UNKNOWN"
            print(f"  {c} ({nid}) intersection={int(vals[rank])} "
                  f"jaccard={jac[rank]:.6g}")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
