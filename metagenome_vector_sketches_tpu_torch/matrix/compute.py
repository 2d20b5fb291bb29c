"""The pairwise engine: one thresholded all-vs-all matrix shard, on the
device.

Port of the JAX package's device-resident fused engine
(``metagenome_vector_sketches_tpu/matrix/compute.py:140-257, 307-388,
415-520, 870-933``):

1. Staging: the int32 vectors go to the device in chunks and are split into
   (P, Npad, d_pad) int8 Karatsuba planes there; thresholds are the
   text-parsed squared norms (+ the certified slack adjustment), 1e30 on
   pad rows.
2. Sweep: kernel S over the shard's TRIANGLE tile grid (only column tiles
   c >= r inside the shard's own row-tile range; mirrors are re-emitted on
   the host), APPEND epilogue with self-pairs masked, chunk by chunk. When
   a chunk's survivor total exceeds the buffer's capacity, the chunk is
   rerun at exactly that capacity (kernel S counts past its cap); when the
   exact size would break the buffer budget, the chunk is halved instead.
3. Partials: kernel X computes the survivors' exact int32 limb-pair
   partials; self-pairs go through kernel X on (i, i).
4. One device->host copy per chunk; the host combines the partials into
   exact int64 dots, applies the reference's exact retention (int32 or
   int16 semantics) and writes the shard with the shared writer.

Not ported yet (a call that needs them cannot be made): the streaming path
for databases beyond device memory, the mesh engine, device finalize and
the sparse-tile gate.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .._device import resolve_device
from ..host import DbFolder, log, write_shard
from ..ops import pairwise as pw
from ..ops import pairwise_math as pm

# per-shard stage timing of the LAST compute_pairwise_shard call (the keys
# of the JAX engine's LAST_STAGES). sweep_ms is kernel S (synchronised),
# extract_ms kernel X plus the device->host copy, finalize_ms the host's
# exact combine and filter.
LAST_STAGES: dict = {}

# int32 bytes of vectors per host->device staging chunk
STAGE_CHUNK_BYTES = 256 << 20
# first capacity (pairs) of the survivor buffer; grows to the exact size
SWEEP_CAP_START = 1 << 22
# bound on the survivor buffer plus its partials (bytes) before a chunk of
# tiles is halved instead of rerun at its exact size
CANDIDATE_BUDGET_BYTES = 4 << 30

_MAX_DISPATCH_WALLS = 50

# tile edges already reported as rounded (each is logged once a process)
_ROUNDED_TILES: set = set()


def sweep_tile(tile_rows: int, device) -> int:
    """The sweep's tile edge on ``device``: tile_rows itself on the CPU; on
    CUDA rounded UP to a multiple of kernel S's block (128), logged once.
    The shard does not depend on the tile (the writer lexsorts)."""
    if torch.device(device).type != "cuda" or tile_rows % pw.SWEEP_BLOCK == 0:
        return tile_rows
    tile = pw.pad_rows(tile_rows, device)
    if tile_rows not in _ROUNDED_TILES:
        _ROUNDED_TILES.add(tile_rows)
        log(f"tile_rows={tile_rows} rounded up to {tile} (kernel S takes "
            f"multiples of {pw.SWEEP_BLOCK} on CUDA)")
    return tile


def _reset_stages():
    LAST_STAGES.clear()
    LAST_STAGES.update(stage_ms=0.0, sweep_ms=0.0, extract_ms=0.0,
                       finalize_ms=0.0, write_ms=0.0,
                       # candidates = survivors read back from the device
                       # (self-pairs included); emitted = pairs handed to
                       # the exact filter inside this shard's row range,
                       # mirror twins included
                       candidates=0, emitted=0, pairs_written=0,
                       stage_decompose_ms=0.0, stage_h2d_ms=0.0,
                       # wall of each sweep chunk (kernel S, synchronised)
                       dispatch_walls_ms=[])


def _acc(key: str, t0: float) -> None:
    if LAST_STAGES:
        LAST_STAGES[key] += (time.perf_counter() - t0) * 1e3


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scan_max_abs(db: DbFolder, chunk: int = 8192) -> int:
    """Global max |component|: max_component.txt when the db has a fresh
    one, else one streaming scan of vectors.bin."""
    cached = db.max_component()
    if cached is not None:
        return cached
    n = db.total_vectors_from_bin()
    m = 0
    for s in range(0, n, chunk):
        block = db.load_vectors(s, min(s + chunk, n))
        if block.size:
            m = max(m, int(block.max()), -int(block.min()))
    return m


def shard_is_complete(output_folder: str, shard_idx: int) -> bool:
    """A shard is complete when its neighbor_start.bin (written last by the
    writer) exists — the unit of checkpoint/restart."""
    return os.path.exists(os.path.join(output_folder, f"shard_{shard_idx}",
                                       "neighbor_start.bin"))


def compute_pairwise_shard(db_folder: str, output_folder: str,
                           num_shards: int = 1, shard_idx: int = 0,
                           tile_rows: int = 2048, resume: bool = False,
                           verbose: bool = True, *, device) -> str:
    """Compute shard ``shard_idx`` of ``num_shards`` of the all-vs-all
    matrix on ``device`` and write its folder; returns the folder path.

    tile_rows is the square tile edge of the sweep (rounded up to a
    multiple of 128 on CUDA, :func:`sweep_tile`). With resume=True an already complete shard is left untouched.
    The shard folder is byte-identical to the JAX engine's on the same db.
    """
    dev = resolve_device(device)
    _reset_stages()
    shard_folder = os.path.join(output_folder, f"shard_{shard_idx}")
    if resume and shard_is_complete(output_folder, shard_idx):
        if verbose:
            log(f"Shard {shard_idx} already complete, skipping (resume)")
        return shard_folder
    tile_rows = sweep_tile(tile_rows, dev)
    db = DbFolder(db_folder)
    d = db.dimension
    _, norms = db.names_and_norms()
    norms_sq = norms * norms  # float64, text round-tripped — reference :900

    total = db.total_vectors_from_bin()
    rows_per_shard = (total + num_shards - 1) // num_shards
    begin_row = shard_idx * rows_per_shard
    end_row = min(begin_row + rows_per_shard, total)
    if verbose:
        log(f"Shard {shard_idx} processing rows {begin_row} to {end_row} "
            f"of {total} (d={d}, dtype={db.dtype}, device={dev})")

    max_abs = scan_max_abs(db)
    pm.check_exact_dot_range(d, max(1, max_abs))
    L = pm.pick_limbs(max(1, max_abs))
    exact_filter = pm.exact_filter_int16 if db.dtype == "int16" \
        else pm.exact_filter_int32

    if begin_row >= end_row:
        # shard beyond the row space (num_shards > N): empty-but-valid folder
        e = np.empty(0, dtype=np.int64)
        write_shard(shard_folder, e, e, e, norms_sq, d)
        return shard_folder

    t0 = time.perf_counter()
    rows, cols, vals = _compute_device_resident(
        db, norms_sq, total, begin_row, end_row, tile_rows, L, d,
        exact_filter, max_abs, dev)
    if verbose:
        dt = (time.perf_counter() - t0) * 1000
        log(f"Total computation time: {dt:.0f} ms ({len(rows)} surviving pairs)")

    tw = time.perf_counter()
    write_shard(shard_folder, rows, cols, vals, norms_sq, d)
    _acc("write_ms", tw)
    LAST_STAGES["pairs_written"] = len(rows)
    LAST_STAGES["total_ms"] = (time.perf_counter() - t0) * 1e3
    return shard_folder


def _stage_database(db, norms_sq, total, tile, L, d, max_abs, dev):
    """-> ((P, Npad, d_pad) int8 planes, (Npad,) float32 thresholds) on
    dev. Peak device memory is the planes plus one int32 chunk."""
    npad = (total + tile - 1) // tile * tile
    d_pad = pw.pad_dim(d)
    P = pm.num_planes(L)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        if P * npad * d_pad > 0.8 * free:
            raise NotImplementedError(
                f"the {P} x {npad} x {d_pad} int8 planes exceed the device's "
                "free memory; the beyond-memory streaming engine is not yet "
                "ported")
    vec_dt = np.int16 if db.dtype == "int16" else np.int32
    V = np.memmap(os.path.join(db.path, "vectors.bin"), dtype=vec_dt,
                  mode="r", shape=(total, d))
    planes = torch.zeros((P, npad, d_pad), dtype=torch.int8, device=dev)
    chunk = max(1, STAGE_CHUNK_BYTES // (4 * d))
    for s in range(0, total, chunk):
        e = min(s + chunk, total)
        t0 = time.perf_counter()
        block = torch.from_numpy(np.array(V[s:e], dtype=np.int32)).to(dev)
        _sync(dev)
        _acc("stage_h2d_ms", t0)
        t0 = time.perf_counter()
        lo, hi = (int(x) for x in torch.aminmax(block))
        if max(hi, -lo) > max_abs:
            raise ValueError(
                f"max_component.txt ({max_abs}) is stale: vectors.bin holds "
                f"|component| up to {max(hi, -lo)}. Delete "
                f"{os.path.join(db.path, 'max_component.txt')} or rebuild "
                "the db folder.")
        pw.planes_update(planes, pw.decompose_limbs(block, L), s)
        del block
        _sync(dev)
        _acc("stage_decompose_ms", t0)
    thr = np.full(npad, np.float32(1e30), dtype=np.float32)
    thr[:total] = (norms_sq + pm.threshold_adjust(L, max_abs, d)) \
        .astype(np.float32)
    return planes, torch.from_numpy(thr).to(dev)


def _make_finalizer(norms_sq, begin_row, end_row, total, d, exact_filter):
    """-> (parts, finalize_dots(r, c, dots, count=True)): the exact
    retention of candidate pairs with exact int64 dots; survivors inside
    this shard's row range are appended to parts as (rows, cols, dots).
    count=False marks a host re-emission (a mirror twin) that was not read
    from the device."""
    parts: list = []

    def finalize_dots(r_glob, c_glob, dots, count: bool = True):
        t0 = time.perf_counter()
        if count:
            LAST_STAGES["candidates"] += len(r_glob)
        keep_range = ((r_glob >= begin_row) & (r_glob < end_row)
                      & (c_glob < total))
        if not keep_range.all():
            r_glob, c_glob = r_glob[keep_range], c_glob[keep_range]
            dots = dots[keep_range]
        LAST_STAGES["emitted"] += len(r_glob)
        if len(r_glob):
            thr_exact = 0.05 * (norms_sq[r_glob] + norms_sq[c_glob])
            keep = exact_filter(dots, thr_exact, d)
            if keep.any():
                parts.append((r_glob[keep], c_glob[keep], dots[keep]))
        _acc("finalize_ms", t0)

    return parts, finalize_dots


def _exact_dots(planes, rc, L):
    """Kernel X on candidate pairs, ONE device->host copy, and the host's
    exact combine -> (rows int64, cols int64, dots int64)."""
    parts = pw.pair_partials(planes, rc, L)
    host = torch.cat([rc, parts], dim=1).cpu().numpy()
    dots = pm.combine_plane_partials(host[:, 2:].T, L)
    return host[:, 0].astype(np.int64), host[:, 1].astype(np.int64), dots


def _compute_device_resident(db, norms_sq, total, begin_row, end_row, tile,
                             L, d, exact_filter, max_abs, dev):
    ts = time.perf_counter()
    planes, thr = _stage_database(db, norms_sq, total, tile, L, d, max_abs,
                                  dev)
    _sync(dev)
    _acc("stage_ms", ts)
    LAST_STAGES["mode"] = "fused"

    nt = planes.shape[1] // tile
    rt0, rt1 = begin_row // tile, (end_row - 1) // tile + 1
    # TRIANGLE tile grid: inside the shard's row-tile range [rt0, rt1) tiles
    # (r, c) and (c, r) carry the same unordered pairs and every per-pair
    # quantity is symmetric, so only c >= r is swept and each off-diagonal
    # survivor is emitted in both directions on the host. Column tiles
    # outside the range keep the full rectangle (their mirror rows belong
    # to other shards).
    coords = np.array([(r, c) for r in range(rt0, rt1) for c in range(nt)
                       if c >= r or not rt0 <= c < rt1],
                      dtype=np.int32).reshape(-1, 2)

    parts, finalize_dots = _make_finalizer(norms_sq, begin_row, end_row,
                                           total, d, exact_filter)

    def fin_dots(r_glob, c_glob, dots):
        finalize_dots(r_glob, c_glob, dots)
        # mirror the candidates whose transposed tile was not swept;
        # diagonal tiles already carry both orders
        ct = c_glob // tile
        m = (ct > r_glob // tile) & (ct >= rt0) & (ct < rt1)
        if m.any():
            finalize_dots(c_glob[m], r_glob[m], dots[m], count=False)

    # self-pairs are masked out of the sweep (diagonal tiles keep ordinary
    # density) and emitted from their exact self dots through kernel X;
    # the reference keeps them (pairwise_comp_optimized.cpp:659)
    t0 = time.perf_counter()
    self_rows = np.arange(begin_row, end_row, dtype=np.int32)
    rc_self = torch.from_numpy(np.stack([self_rows, self_rows], 1)).to(dev)
    r, c, dots = _exact_dots(planes, rc_self, L)
    _acc("extract_ms", t0)
    finalize_dots(r, c, dots)

    _sweep(planes, thr, tile, L, d, coords, fin_dots, dev)
    return _concat(parts)


def _sweep(planes, thr, tile, L, d, coords, fin_dots, dev):
    """Kernel S over ``coords`` chunk by chunk, kernel X on each chunk's
    survivors, then the host finalize."""
    T = len(coords)
    per_pair = (2 + pm.num_planes(L)) * 4        # rc + partials bytes
    # kernel S counts in 32 bits: a chunk holds fewer than 2^31 pairs
    chunk = max(1, min(T, (2**31 - 1) // (tile * tile)))
    cap = SWEEP_CAP_START
    s = 0
    while s < T:
        e = min(s + chunk, T)
        t0 = time.perf_counter()
        rc, _, total = pw.sweep_extract(planes, thr, planes, thr,
                                        coords[s:e], tile, cap, True, d)
        n = int(total.item())
        if n > cap:
            if n * per_pair > CANDIDATE_BUDGET_BYTES and e - s > 1:
                chunk = (e - s) // 2                  # same start, fewer tiles
                _acc("sweep_ms", t0)
                continue
            cap = n
            rc, _, total = pw.sweep_extract(planes, thr, planes, thr,
                                            coords[s:e], tile, cap, True, d)
            if int(total.item()) != n:
                raise RuntimeError(f"sweep rerun found {int(total.item())} "
                                   f"survivors, the first run {n}")
        _sync(dev)
        _acc("sweep_ms", t0)
        walls = LAST_STAGES["dispatch_walls_ms"]
        if len(walls) < _MAX_DISPATCH_WALLS:
            walls.append(round((time.perf_counter() - t0) * 1e3, 1))
        t0 = time.perf_counter()
        r, c, dots = _exact_dots(planes, rc[:n], L)
        _acc("extract_ms", t0)
        fin_dots(r, c, dots)
        s = e


def _concat(parts):
    if not parts:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), e.copy()
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]))
