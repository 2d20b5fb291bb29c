"""project_everything: convert signature folders to hash files and sketch
them into db folders (reference CLI: src/project_everything.cpp:364-417).

Usage:
  project_everything convert <signature_folder> <hash_file> [-t threads]
  project_everything sketch <hash_file> <index_folder> [-t threads]
                            [-d dimension] [--int16]
                            [--device cuda|cpu|host|device|auto]
"""

from __future__ import annotations

import argparse
import sys

from .._device import CLI_DEFAULT_DEVICE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="project_everything")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("convert", help="Load signatures, write hash file")
    c.add_argument("signature_folder", help="Path to folder containing signature files")
    c.add_argument("hash_file", help="Output hash file path")
    c.add_argument("-t", "--threads", type=int, default=1)

    s = sub.add_parser("sketch", help="Project hash sets into a db folder")
    s.add_argument("hash_file", help="Input hash file path")
    s.add_argument("index_folder", help="Output folder for index files")
    s.add_argument("-t", "--threads", type=int, default=1)
    s.add_argument("-d", "--dimension", type=int, default=2048)
    s.add_argument("--int16", action="store_true",
                   help="Use int16 instead of int32 for vector storage")
    s.add_argument("--device", default=CLI_DEFAULT_DEVICE,
                   help="torch device of the projection (default cuda); "
                        "the JAX tool's host, device and auto mean cpu, "
                        "cuda and cuda")
    return p


# the JAX tool's --device choices as torch devices: host is the CPU, device
# and auto the card (never a silent fall back to the CPU)
JAX_DEVICE_NAMES = {"host": "cpu", "device": CLI_DEFAULT_DEVICE,
                    "auto": CLI_DEFAULT_DEVICE}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..io import ingest
    if args.command == "convert":
        ingest.convert(args.signature_folder, args.hash_file,
                       num_threads=args.threads)
    else:
        ingest.sketch(args.hash_file, args.index_folder,
                      dimension=args.dimension, use_int16=args.int16,
                      device=JAX_DEVICE_NAMES.get(args.device, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
