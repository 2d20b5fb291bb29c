"""jaccard: flat-IP index build, adaptive nearest-neighbour search and
ground-truth validation (reference CLI: src/jaccard.py:327-363).

The reference's subcommands and flags, the JAX package's extensions,
plus --device (default cuda):
  jaccard index <output_index_folder> [-t threads]
  jaccard search <index_folder> <query_file> [-j jaccard] [--engine ...]
  jaccard test <index_folder> <hashes_file> [-n samples] [-j jaccard]
--mesh_devices 0 means every local device of --device's type (one on the
CPU), n > 1 the first n, served through the distributed indexes; more
devices than the process has are refused, as in the JAX package.
`index` is host work (normalise + write faiss.index); its --device is
checked like the others'.
"""

from __future__ import annotations

import argparse
import sys

from .._device import CLI_DEFAULT_DEVICE, resolve_device

__version__ = "0.1.0"
__date__ = "2026-08-16"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Flat-IP indexer and searcher.")
    # not required at parse time so a bare `jaccard -v` can print the
    # version (the reference's required=True makes its own -v branch
    # unreachable standalone, src/jaccard.py:333-352); main() errors on
    # a missing command when -v was not given
    sub = parser.add_subparsers(dest="command")

    p_index = sub.add_parser("index", help="Index vectors from a db folder.")
    p_index.add_argument("output_index",
                         help="Path to index folder [same folder contains the vectors].")
    p_index.add_argument("-t", "--threads", type=int, default=1)

    p_search = sub.add_parser("search", help="Search vectors in the index.")
    p_search.add_argument("index_folder")
    p_search.add_argument("query_file",
                          help="Formatted as 'ID: space_separated_hashes', one per line")
    p_search.add_argument("-j", type=float, default=0.1,
                          help="Retrieve all datasets with higher Jaccard index")
    p_search.add_argument("-t", "--threads", type=int, default=1)
    p_search.add_argument("--recall_target", type=float, default=1.0,
                          help="< 1.0 uses the ~2x-faster approximate TPU "
                               "top-k for candidate selection (final Jaccard "
                               "rescoring stays exact); 1.0 = FAISS-exact")
    p_search.add_argument("--engine", choices=("f32", "int8", "int8_approx"),
                          default="f32",
                          help="f32: FAISS-parity search over faiss.index; "
                               "int8: int8-plane exact engine staged from "
                               "the db's integer vectors (float64-exact "
                               "cosines, no faiss.index needed); "
                               "int8_approx: same with approx_max_k pooling")
    p_search.add_argument("--mesh_devices", type=int, default=1,
                          help="Serve mesh-sharded over this many local "
                               "devices (0 = all, 1 = single device; "
                               "extension — results are identical, candidate "
                               "pools merge over ICI)")

    p_test = sub.add_parser(
        "test", help="Ground-truth validation: sample accessions, search the "
                     "index, recompute TRUE Jaccard from the raw hash sets "
                     "(reference jaccard.py test(), :226-325).")
    p_test.add_argument("index_folder")
    p_test.add_argument("hashes_file", help="all_hashes.txt the db was built from")
    p_test.add_argument("-n", "--n_samples", type=int, default=20)
    p_test.add_argument("-j", type=float, default=0.05)
    p_test.add_argument("--seed", type=int, default=None)
    p_test.add_argument("--save_plot", default=None,
                        help="write the estimated-vs-true scatter to this path")
    p_test.add_argument("--engine", choices=("f32", "int8", "int8_approx"),
                        default="f32")
    p_test.add_argument("--mesh_devices", type=int, default=1)
    parser.add_argument("-v", "--version", action="store_true")
    for sub_parser in (p_index, p_search, p_test):
        sub_parser.add_argument("--device", default=CLI_DEFAULT_DEVICE,
                                help="torch device (default cuda)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "version", False):
        print(f"Version: {__version__}, Date: {__date__}")
        return 0
    if not args.command:
        parser.error("the following arguments are required: command")
    device = resolve_device(args.device)
    print(f"Version: {__version__}, Date: {__date__}")
    print("Command line:", " ".join(sys.argv))
    if args.command == "index":
        from ..ann.flat_index import index_vectors
        index_vectors(args.output_index)
    elif args.command == "search":
        from ..ann.search import search_index
        folder = args.index_folder
        if not folder.endswith("/"):
            folder += "/"
        search_index(folder, args.query_file, args.j,
                     recall_target=args.recall_target, engine=args.engine,
                     mesh_devices=args.mesh_devices, device=device)
    elif args.command == "test":
        from ..ann.validate import validate
        validate(args.index_folder, args.hashes_file,
                 n_samples=args.n_samples, j=args.j, seed=args.seed,
                 plot=False, save_plot=args.save_plot, engine=args.engine,
                 mesh_devices=args.mesh_devices, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
