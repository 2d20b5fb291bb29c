"""pairwise_comp: compute one shard of the all-vs-all thresholded pairwise
matrix on the device (reference CLI: src/pairwise_comp_optimized.cpp:834-844).

The JAX package's flags, plus --device (default cuda). --strategy 1 writes
the exact MinHash shard from --hashes; --finalize and --gate_sparse_tiles
are accepted and write the same shard as a plain run, as in the JAX
package. Only --mesh_devices above 1 (the multi-GPU engine, not ported yet)
is refused.
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
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _not_ported(args)
    if why:
        print(f"pairwise_comp: {why}", file=sys.stderr)
        return 2
    from ..matrix.compute import compute_minhash_shard, compute_pairwise_shard
    if args.strategy == 1:
        if not args.hashes:
            print("--strategy 1 requires --hashes <all_hashes.txt>",
                  file=sys.stderr)
            return 1
        compute_minhash_shard(args.hashes, args.output_folder,
                              num_shards=args.num_shards,
                              shard_idx=args.shard_idx, db_folder=args.db,
                              device=args.device)
        return 0
    # a power of two in [256, 2048]: a multiple of kernel S's block
    tile = args.tile or tile_from_memory(args.max_memory_gb,
                                         DbFolder(args.db).dimension)
    compute_pairwise_shard(args.db, args.output_folder,
                           num_shards=args.num_shards,
                           shard_idx=args.shard_idx, tile_rows=tile,
                           resume=args.resume,
                           finalize=None if args.finalize == "auto"
                           else args.finalize,
                           gate=args.gate_sparse_tiles, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
