"""Kernel COUNT: the contract of the JAX package's one Pallas kernel,
``metagenome_vector_sketches_tpu/ops/pallas_pairwise.py:55``
``pallas_sweep_counts`` (named after that module, so a reader finds the
counterpart).

Survivor counts of tiles: per tile, the P int8 plane products, the float32
combine and the retention test of ops/pairwise.py, summed. A CUDA tensor
launches kernel COUNT (``csrc/count.cu``, entry ``mvs_count``), whose tile
edges must be multiples of 128; a CPU tensor takes the plain version.

- :func:`sweep_counts`: row tiles [row_t0, row_t1) of edge ``block`` x ALL
  column tiles of edge ``block_j`` (``pallas_sweep_counts``'s contract).
- :func:`count_tiles`: the two-phase engine's counts sweep (matrix/compute.py)
  over a list of extraction tiles (:class:`~.pairwise.TileList`: checked
  and copied to the card once per list). The kernel splits the tiles into
  its own work
  items and sums each tile's survivors on the card: integer sums do not
  depend on the split, so the JAX engine's VMEM sub-blocks
  (:func:`engine_blocks`) only describe how its TPU kernel swept.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .pairwise import (SWEEP_BLOCK, approx_dot_f32, check_operands,
                       check_tiles, retention_mask, tile_list)
from .pairwise import TileList  # noqa: F401  (this module's name for it)
from .pairwise_math import (SLACK_ABS, SLACK_REL, limbs_from_planes,
                            plane_weights)


def _grid(npad: int, row_t0: int, row_t1: int | None, block: int,
          block_j: int | None):
    block_j = block if block_j is None else block_j
    if npad % block or npad % block_j:
        raise ValueError(f"Npad={npad} must be a multiple of block={block} "
                         f"and block_j={block_j}")
    nti = npad // block
    row_t1 = nti if row_t1 is None else row_t1
    if not 0 <= row_t0 <= row_t1 <= nti:
        raise ValueError(f"row tiles [{row_t0}, {row_t1}) outside [0, {nti})")
    return row_t1, block_j, npad // block_j


def _launch_count(planes_i, thr_i, planes_j, thr_j, coords_dev, n_tiles: int,
                  tile_r: int, tile_c: int, d: int, row_t0: int = 0,
                  n_col_tiles: int = 0) -> torch.Tensor:
    """One launch of kernel COUNT -> (n_tiles,) int32 counts on the device.
    coords_dev: the (n_tiles, 2) int32 tile list on the planes' device, or
    None for the dense grid of row tiles [row_t0, ...) x n_col_tiles column
    tiles. The caller has checked that the tiles lie inside the planes."""
    dev = planes_i.device
    check_operands(planes_i, thr_i, planes_j, thr_j, tile_r, tile_c, d,
                   "COUNT")
    P, ni, d_pad = planes_i.shape
    nj = planes_j.shape[1]
    counts = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    if n_tiles == 0:
        return counts
    w = plane_weights(limbs_from_planes(P))
    lib = _build.library()
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_count(
            planes_i.data_ptr(), planes_j.data_ptr(), thr_i.data_ptr(),
            thr_j.data_ptr(), P, d, d_pad, ni, nj,
            None if coords_dev is None else coords_dev.data_ptr(), n_tiles,
            row_t0, n_col_tiles, tile_r, tile_c,
            w.ctypes.data_as(ctypes.c_void_p), float(SLACK_REL),
            float(SLACK_ABS), counts.data_ptr(), stream)
    _build.check(err, "count kernel")
    _build.count_launch("count")
    return counts


def sweep_counts_plain(planes: torch.Tensor, thr: torch.Tensor, d: int,
                       row_t0: int = 0, row_t1: int | None = None,
                       block: int = 512,
                       block_j: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`sweep_counts`."""
    npad = planes.shape[1]
    row_t1, block_j, ntj = _grid(npad, row_t0, row_t1, block, block_j)
    out = torch.empty((row_t1 - row_t0, ntj), dtype=torch.int32,
                      device=planes.device)
    for i, r in enumerate(range(row_t0, row_t1)):
        rows = slice(r * block, (r + 1) * block)
        m = retention_mask(approx_dot_f32(planes[:, rows], planes),
                           thr[rows], thr, d)
        out[i] = m.reshape(block, ntj, block_j).sum(dim=(0, 2)).to(torch.int32)
    return out


def sweep_counts(planes: torch.Tensor, thr: torch.Tensor, d: int,
                 row_t0: int = 0, row_t1: int | None = None,
                 block: int = 512, block_j: int | None = None) -> torch.Tensor:
    """(row_t1 - row_t0, Npad // block_j) int32 survivor counts of the
    (block x block_j) tiles, on the planes' device.

    planes: (P, Npad, d_pad) int8 Karatsuba planes; thr: (Npad,) float32
    squared norms (1e30 on pad rows); d: the true dimension (the divisor of
    the retention test)."""
    if planes.device.type == "cpu":
        return sweep_counts_plain(planes, thr, d, row_t0, row_t1, block,
                                  block_j)
    row_t1, block_j, ntj = _grid(planes.shape[1], row_t0, row_t1, block,
                                 block_j)
    n = row_t1 - row_t0
    return _launch_count(planes, thr, planes, thr, None, n * ntj, block,
                         block_j, d, row_t0, ntj).reshape(n, ntj)


def engine_blocks(P: int, tile: int, device) -> tuple[int, int]:
    """The JAX two-phase engine's COUNT sub-blocks (BI, BJ) for extraction
    tiles of edge ``tile`` and P planes (JAX ``matrix/compute.py:822-829``):
    (512, 512) for P <= 3, (512, 128) for P <= 6, each halved while it does
    not divide the tile, BJ <= BI, never below 128 rows; the tile itself for
    P > 6 and on the CPU. The rule sized its TPU kernel's VMEM blocks;
    kernel COUNT has work items of its own, so here it is the split at
    which the plain version sweeps the CPU path (:func:`count_tiles`) and
    the parity tests hold it against JAX."""
    if torch.device(device).type != "cuda" or P > 6:
        return tile, tile
    bi, bj = (512, 512) if P <= 3 else (512, 128)
    while bi > SWEEP_BLOCK and tile % bi:
        bi //= 2
    while bj > SWEEP_BLOCK and (tile % bj or bj > bi):
        bj //= 2
    return bi, bj


def count_tiles_plain(planes_i, thr_i, planes_j, thr_j, coords, tile: int,
                      d: int, blocks: tuple[int, int] | None = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`count_tiles`: each (tile x tile)
    tile swept in (BI x BJ) = ``blocks`` sub-blocks (the whole tile by
    default), their counts summed to the tile."""
    bi, bj = (tile, tile) if blocks is None else blocks
    if tile % bi or tile % bj:
        raise ValueError(f"blocks {blocks} do not divide the tile {tile}")
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    out = torch.zeros(len(coords), dtype=torch.int32, device=planes_i.device)
    for k, (r, c) in enumerate(coords.tolist()):
        for a in range(r * tile, (r + 1) * tile, bi):
            for b in range(c * tile, (c + 1) * tile, bj):
                out[k] += retention_mask(
                    approx_dot_f32(planes_i[:, a:a + bi],
                                   planes_j[:, b:b + bj]),
                    thr_i[a:a + bi], thr_j[b:b + bj], d).sum() \
                    .to(torch.int32)
    return out


def count_tiles(planes_i, thr_i, planes_j, thr_j, coords, tile: int,
                d: int) -> torch.Tensor:
    """(K,) int32 survivor counts (self-pairs kept) of the (tile x tile)
    tiles ``coords`` (a :class:`~.pairwise.TileList`, or (K, 2) row tiles
    of planes_i and column tiles of planes_j), on the planes' device: ONE
    launch of kernel COUNT, which sums every tile's survivors on the card
    (CPU tensors: the plain version at :func:`engine_blocks`)."""
    coords = tile_list(coords, planes_i.device)
    check_tiles(planes_i, planes_j, coords, tile, tile)
    if planes_i.device.type == "cpu":
        return count_tiles_plain(planes_i, thr_i, planes_j, thr_j,
                                 coords.host, tile, d,
                                 engine_blocks(planes_i.shape[0], tile,
                                               planes_i.device))
    return _launch_count(planes_i, thr_i, planes_j, thr_j, coords.dev,
                         len(coords), tile, tile, d)
