"""pairwise_comp: compute one shard of the all-vs-all thresholded pairwise
matrix on the device (reference CLI: src/pairwise_comp_optimized.cpp:834-844).

The JAX package's flags, plus --device (default cuda). Options whose
engines are not ported yet (--mesh_devices above 1, --finalize device,
--strategy 1, --gate_sparse_tiles) are refused.
"""

from __future__ import annotations

import sys

from .._device import CLI_DEFAULT_DEVICE
from ..host import DbFolder, pairwise_comp_parser, tile_from_memory


def build_parser():
    p = pairwise_comp_parser()
    p.add_argument("--device", default=CLI_DEFAULT_DEVICE,
                   help="torch device of the engine (default cuda)")
    return p


def _not_ported(args) -> str | None:
    if args.mesh_devices not in (0, 1):
        return "--mesh_devices > 1 (the multi-GPU engine) is not yet ported"
    if args.finalize == "device":
        return "--finalize device is not yet ported (the port combines " \
               "exact partials on the host)"
    if args.strategy == 1:
        return "--strategy 1 (MinHash) is not yet ported"
    if args.gate_sparse_tiles:
        return "--gate_sparse_tiles is not yet ported"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _not_ported(args)
    if why:
        print(f"pairwise_comp: {why}", file=sys.stderr)
        return 2
    from ..matrix.compute import compute_pairwise_shard
    # a power of two in [256, 2048]: a multiple of kernel S's block
    tile = args.tile or tile_from_memory(args.max_memory_gb,
                                         DbFolder(args.db).dimension)
    compute_pairwise_shard(args.db, args.output_folder,
                           num_shards=args.num_shards,
                           shard_idx=args.shard_idx, tile_rows=tile,
                           resume=args.resume, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
