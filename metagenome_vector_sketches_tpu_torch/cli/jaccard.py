"""jaccard: flat-IP index build, adaptive nearest-neighbour search and
ground-truth validation (reference CLI: src/jaccard.py:327-363).

The JAX package's subcommands and flags, plus --device (default cuda):
  jaccard index <output_index_folder> [-t threads]
  jaccard search <index_folder> <query_file> [-j jaccard] [--engine ...]
  jaccard test <index_folder> <hashes_file> [-n samples] [-j jaccard]
--mesh_devices other than 1 (the multi-GPU serving engine) is refused.
`index` is host work (normalise + write faiss.index); its --device is
checked like the others'.
"""

from __future__ import annotations

import argparse
import sys

from .._device import CLI_DEFAULT_DEVICE, resolve_device
from ..host import jaccard_cli


def build_parser() -> argparse.ArgumentParser:
    parser = jaccard_cli.build_parser()
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sub in action.choices.values():
                sub.add_argument("--device", default=CLI_DEFAULT_DEVICE,
                                 help="torch device (default cuda)")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "version", False):
        print(f"Version: {jaccard_cli.__version__}, "
              f"Date: {jaccard_cli.__date__}")
        return 0
    if not args.command:
        parser.error("the following arguments are required: command")
    if getattr(args, "mesh_devices", 1) != 1:
        print("jaccard: --mesh_devices other than 1 (the multi-GPU serving "
              "engine) is not yet ported", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    print(f"Version: {jaccard_cli.__version__}, Date: {jaccard_cli.__date__}")
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
                     device=device)
    elif args.command == "test":
        from ..ann.validate import validate
        validate(args.index_folder, args.hashes_file,
                 n_samples=args.n_samples, j=args.j, seed=args.seed,
                 plot=False, save_plot=args.save_plot, engine=args.engine,
                 device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
