"""pairwise_comp: compute one shard of the all-vs-all thresholded pairwise
matrix on the device (reference CLI: src/pairwise_comp_optimized.cpp:834-844).

The reference's flags and the JAX package's extensions, plus --device
(default cuda). --strategy 1 writes the exact MinHash shard from --hashes; --finalize and --gate_sparse_tiles
are accepted and write the same shard as a plain run, as in the JAX
package. --mesh_devices n > 1 runs the shard mesh-parallel over the first
n local devices of --device's type (0: every local device), and more
devices than the process has are refused, as in the JAX package.
"""

from __future__ import annotations

import argparse
import sys

from .._device import CLI_DEFAULT_DEVICE
from ..io.dbfolder import DbFolder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pairwise_comp")
    p.add_argument("--db", required=True, help="db folder")
    p.add_argument("--max_memory_gb", type=float, required=True)
    p.add_argument("--num_threads", type=int, required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--num_shards", type=int, required=True)
    p.add_argument("--shard_idx", type=int, required=True)
    p.add_argument("--start_shard", type=int, default=None,
                   help="(vestigial in the reference; accepted, unused)")
    p.add_argument("--end_shard", type=int, default=None,
                   help="(vestigial in the reference; accepted, unused)")
    p.add_argument("--tile", type=int, default=None,
                   help="Device tile edge override (extension)")
    p.add_argument("--resume", action="store_true",
                   help="Skip the shard if its folder is already complete "
                        "(extension; the shard is the checkpoint unit)")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="Run the engine mesh-parallel over this many local "
                        "devices (0 = all local devices, 1 = single device; "
                        "extension — one shard then uses every chip)")
    p.add_argument("--finalize", choices=["auto", "host", "device"],
                   default="auto",
                   help="Exact candidate-dot recomputation site (extension): "
                        "host = float64 BLAS from the resident vectors; "
                        "device = int32 limb partials on the chip, O(K) host "
                        "combine; auto = device on TPU backends")
    p.add_argument("--gate_sparse_tiles", action="store_true",
                   help="Skip selection work on candidate-free tiles via an "
                        "HLO conditional (extension). Only for genuinely "
                        "SPARSE tile grids (most tiles empty); at production "
                        "density the conditional costs ~17% (measured at "
                        "N=262k, tile=2048 on v5e)")
    p.add_argument("--strategy", type=int, default=0, choices=[0, 1],
                   help="0 = projected-sketch estimates (default); 1 = exact "
                        "MinHash set Jaccard from --hashes (the reference's "
                        "historical strategy 1)")
    p.add_argument("--hashes", default=None,
                   help="all_hashes.txt for --strategy 1")
    p.add_argument("--device", default=CLI_DEFAULT_DEVICE,
                   help="torch device of the engine (default cuda)")
    return p


def tile_from_memory(max_memory_gb: float, dimension: int) -> int:
    """Pick a device tile edge from the memory budget: two limb blocks of
    tile x d int8 x L(<=3) plus the int32 partial tiles must fit. (The
    reference's own formula divides by bytes_per_vector^2 — a known bug we
    deliberately do not copy; SURVEY.md 'known reference bugs'.)"""
    budget = max_memory_gb * (1 << 30)
    # solve 48*tile^2 + 6*tile*d <= budget (the ~9 int32 partial tiles of
    # tile^2 bytes PLUS the 6 int8 limb blocks of tile x d, so the
    # dimension the signature advertises actually shapes the answer)
    import math
    d = float(max(1, dimension))
    tile = int((-6 * d + math.sqrt(36 * d * d
                                   + 4 * 48 * max(1.0, budget))) / 96.0)
    # cap at 2048: larger extraction tiles recompute needlessly coarse hot
    # regions and the counts sweep runs at a fixed 512 pallas block anyway
    tile = max(256, min(2048, 1 << (tile.bit_length() - 1)))
    return tile


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
    # LOCAL devices (parallel.mesh.serving_mesh's 1/0/n rule, with its
    # range checks)
    from ..parallel.mesh import serving_mesh
    mesh = serving_mesh(args.mesh_devices, device=args.device)
    compute_pairwise_shard(args.db, args.output_folder,
                           num_shards=args.num_shards,
                           shard_idx=args.shard_idx, tile_rows=tile,
                           resume=args.resume, mesh=mesh,
                           finalize=None if args.finalize == "auto"
                           else args.finalize,
                           gate=args.gate_sparse_tiles, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
