"""standalone_projection: lines of whitespace-separated hashes on a file ->
one projected vector per line on stdout, floats space-separated
(reference: src/standalone_projection.cpp:11-46).

Usage: standalone_projection <hashes_file> <dimension> [--device cuda|cpu]

Missing arguments print the JAX tool's usage line and return 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .._device import CLI_DEFAULT_DEVICE


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="standalone_projection")
    p.add_argument("hashes_file", nargs="?")
    p.add_argument("dimension", type=int, nargs="?")
    p.add_argument("--device", default=CLI_DEFAULT_DEVICE)
    args = p.parse_args(argv)
    if args.dimension is None:
        print("Usage: standalone_projection <hashes_file> <dimension>",
              file=sys.stderr)
        return 1
    lines = []
    with open(args.hashes_file) as f:
        for line in f:
            vals = line.split()
            lines.append(np.unique(np.array(vals, dtype=np.uint64)) if vals
                         else np.empty(0, dtype=np.uint64))
    from ..io.ingest import project_hash_lines
    vecs = project_hash_lines(lines, args.dimension, device=args.device)
    out = sys.stdout
    for row in vecs:
        # reference prints static_cast<float>(int) via operator<< (%.6g)
        out.write(" ".join(f"{float(np.float32(x)):g}" for x in row))
        out.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
