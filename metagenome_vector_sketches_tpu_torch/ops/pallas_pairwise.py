"""Kernel S in its COUNT epilogue: the contract of the JAX package's one
Pallas kernel, ``metagenome_vector_sketches_tpu/ops/pallas_pairwise.py:55``
``pallas_sweep_counts`` (named after that module, so a reader finds the
counterpart).

Survivor counts for row tiles [row_t0, row_t1) of edge ``block`` x ALL
column tiles of edge ``block_j``: per tile, the P int8 plane products, the
float32 combine and the retention test of ops/pairwise.py, summed. A CUDA
tensor launches kernel S (``csrc/sweep.cu``), whose blocks must then be
multiples of 128; a CPU tensor takes :func:`sweep_counts_plain`.

The two-phase engine (matrix/compute.py) runs the same launch through
:func:`count_tiles`: its counts sweep over a list of extraction tiles, each
swept at the engine's sub-blocks (:func:`engine_blocks`, JAX
``matrix/compute.py:822-829``) and the sub-block counts summed to the tile
(``:840-842``).
"""

from __future__ import annotations

import numpy as np
import torch

from .pairwise import SWEEP_BLOCK, approx_dot_f32, launch_sweep, retention_mask


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
    coords = np.array([(r, c) for r in range(row_t0, row_t1)
                       for c in range(ntj)], dtype=np.int32).reshape(-1, 2)
    counts, _, _ = launch_sweep(planes, thr, planes, thr, coords, block,
                                block_j, d, append=False, mask_self=False)
    return counts.reshape(row_t1 - row_t0, ntj)


def engine_blocks(P: int, tile: int, device) -> tuple[int, int]:
    """The two-phase engine's COUNT sub-blocks (BI, BJ) for extraction tiles
    of edge ``tile`` and P planes (JAX ``matrix/compute.py:822-829``):
    (512, 512) for P <= 3, (512, 128) for P <= 6, each halved while it does
    not divide the tile, BJ <= BI, never below kernel S's 128-row block;
    the tile itself for P > 6 and on the CPU (the plain counts at the
    extraction tile)."""
    if torch.device(device).type != "cuda" or P > 6:
        return tile, tile
    bi, bj = (512, 512) if P <= 3 else (512, 128)
    while bi > SWEEP_BLOCK and tile % bi:
        bi //= 2
    while bj > SWEEP_BLOCK and (tile % bj or bj > bi):
        bj //= 2
    return bi, bj


def count_tiles_plain(planes_i, thr_i, planes_j, thr_j, coords, block: int,
                      block_j: int, d: int) -> torch.Tensor:
    """Plain PyTorch version of kernel S COUNT over the (block x block_j)
    tiles ``coords``."""
    out = torch.empty(len(coords), dtype=torch.int32, device=planes_i.device)
    for k, (r, c) in enumerate(np.asarray(coords).tolist()):
        rows = slice(r * block, (r + 1) * block)
        cols = slice(c * block_j, (c + 1) * block_j)
        out[k] = retention_mask(approx_dot_f32(planes_i[:, rows],
                                               planes_j[:, cols]),
                                thr_i[rows], thr_j[cols], d).sum()
    return out


def count_tiles(planes_i, thr_i, planes_j, thr_j, coords, tile: int, d: int,
                blocks: tuple[int, int]) -> torch.Tensor:
    """(K,) int32 survivor counts (self-pairs kept) of the (tile x tile)
    tiles ``coords`` ((K, 2) row tile of planes_i, column tile of planes_j),
    on the planes' device: ONE launch of kernel S COUNT over every
    (BI x BJ) = ``blocks`` sub-block of those tiles (CPU tensors: the plain
    version), the sub-block counts summed to the tile."""
    bi, bj = blocks
    if tile % bi or tile % bj:
        raise ValueError(f"blocks {blocks} do not divide the tile {tile}")
    mi, mj = tile // bi, tile // bj
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    rows = coords[:, 0, None, None] * mi + np.arange(mi)[None, :, None]
    cols = coords[:, 1, None, None] * mj + np.arange(mj)[None, None, :]
    sub = np.stack(np.broadcast_arrays(rows, cols), axis=-1).reshape(-1, 2)
    if planes_i.device.type == "cpu":
        counts = count_tiles_plain(planes_i, thr_i, planes_j, thr_j, sub, bi,
                                   bj, d)
    else:
        counts, _, _ = launch_sweep(planes_i, thr_i, planes_j, thr_j, sub, bi,
                                    bj, d, append=False, mask_self=False)
    return counts.reshape(len(coords), mi * mj).sum(dim=1, dtype=torch.int32)
