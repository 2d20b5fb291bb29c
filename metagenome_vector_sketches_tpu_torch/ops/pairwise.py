"""Pairwise similarity on the device: int8 Karatsuba planes, the thresholded
sweep with survivor compaction over a tile list (kernel APPEND, the second
epilogue of kernel COUNT's pipeline, csrc/count.cu; the survivor counts
alone are kernel COUNT, ops/pallas_pairwise.py), the int8 ANN engine's
scores of query planes against database planes (kernel S, SCORE epilogue),
exact limb-pair partials of candidate pairs (kernel X), and the exact
retention of candidate pairs on the card (kernel X's retention epilogue).

The database lives on the device as a (P, Npad, d_pad) int8 plane tensor
(P = L(L+1)/2: the L balanced base-128 limbs, then the pairwise limb sums;
see ops/pairwise_math.plane_weights) next to (Npad,) float32 squared-norm
thresholds, 1e30 on pad rows so they never pass. d_pad rounds d up to a
multiple of 64 with zero columns: zero columns change no dot, so the kernels
never see a ragged d.

Each kernel wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors (or raises); there is no fall back.
The plain versions compute every plane product exactly (float64 products
of int8 values stay exact integers below 2^53) and the float32 combine and
retention test with the same eager float32 ops, in the same order, as the
kernel — so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .pairwise_math import (SLACK_ABS, SLACK_REL, combine_plane_partials,
                            limbs_from_planes, num_planes, plane_weights)

D_ALIGN = 64          # d_pad granularity (kernel S's K step)
SWEEP_BLOCK = 128     # the kernels' row block: CUDA tiles are multiples of it


def pad_dim(d: int) -> int:
    return (d + D_ALIGN - 1) // D_ALIGN * D_ALIGN


def pad_rows(n: int, device) -> int:
    """Rows of a plane tensor that holds n rows on ``device``: a multiple of
    the kernels' block on CUDA (zero rows), n itself on the CPU."""
    if torch.device(device).type != "cuda":
        return n
    return max(1, (n + SWEEP_BLOCK - 1) // SWEEP_BLOCK) * SWEEP_BLOCK


# ---------------------------------------------------------------------------
# Plane staging (plain torch ops: elementwise, once per database)
# ---------------------------------------------------------------------------

def decompose_limbs(v: torch.Tensor, L: int) -> torch.Tensor:
    """(n, d) int32 -> (L, n, d) int8 balanced base-128 limbs (each in
    [-64, 63] for L > 1; v = sum_k limb_k * 2^(7k))."""
    cur = v.to(torch.int32)
    limbs = []
    for _ in range(L - 1):
        digit = ((cur + 64) & 127) - 64
        limbs.append(digit.to(torch.int8))
        cur = (cur - digit) >> 7          # exact arithmetic shift
    limbs.append(cur.to(torch.int8))
    return torch.stack(limbs)


def karatsuba_planes(limbs: torch.Tensor) -> torch.Tensor:
    """(L, n, d) int8 limbs -> (L(L+1)/2, n, d) int8 planes: the limbs, then
    the limb sums limb_a + limb_b for a < b (|sum| <= 128 fits int8)."""
    L = limbs.shape[0]
    sums = [limbs[a] + limbs[b] for a in range(L) for b in range(a + 1, L)]
    if not sums:
        return limbs
    return torch.cat([limbs, torch.stack(sums)], dim=0)


def planes_update(buf: torch.Tensor, limbs: torch.Tensor, start: int) -> None:
    """Write one chunk's planes into the preallocated (P, Npad, d_pad) int8
    buffer IN PLACE at row ``start`` (columns past d stay zero)."""
    _, n, d = limbs.shape
    buf[:, start:start + n, :d] = karatsuba_planes(limbs)


def plane_energies(planes: torch.Tensor) -> torch.Tensor:
    """(P, n, d_pad) int8 planes -> (P, n) int64 energies E_p(i) = sum_k
    planes[p, i, k]^2, exact: each square (|value| <= 128) fits int16, a
    plane at a time."""
    out = torch.empty(planes.shape[:2], dtype=torch.int64,
                      device=planes.device)
    for p in range(planes.shape[0]):
        sq = planes[p].to(torch.int16)
        out[p] = sq.mul_(sq).sum(1, dtype=torch.int64)
    return out


# ---------------------------------------------------------------------------
# The float32 sweep math, written once
# ---------------------------------------------------------------------------

def plane_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 x (n, k) int8 -> (m, n) int32 exact dot products."""
    return (x.to(torch.float64) @ y.to(torch.float64).T).to(torch.int32)


def approx_dot_f32(vi: torch.Tensor, vj: torch.Tensor) -> torch.Tensor:
    """(P, m, k), (P, n, k) int8 planes -> (m, n) float32 combined dot:
    f32(S_0)*w_0, then + f32(S_p)*w_p in plane order (the order of the JAX
    package's approx_dot_f32, ops/pairwise.py:214-236)."""
    w = plane_weights(limbs_from_planes(vi.shape[0]))
    approx = plane_product(vi[0], vj[0]).to(torch.float32) * float(w[0])
    for p in range(1, vi.shape[0]):
        approx = approx + plane_product(vi[p], vj[p]).to(torch.float32) \
            * float(w[p])
    return approx


def retention_mask(approx: torch.Tensor, thr_i: torch.Tensor,
                   thr_j: torch.Tensor, d: int, slack_rel: float = SLACK_REL,
                   slack_abs: float = SLACK_ABS) -> torch.Tensor:
    """THE float32 retention predicate of the sweep:
    approx / d > 0.05 * (t_i + t_j) * slack_rel - slack_abs, one rounded op
    at a time (kernel S runs the same sequence; slack 1 and 0 give the raw
    test 0.05 * (t_i + t_j) exactly). The divisor is a device tensor:
    PyTorch's CUDA division by a CPU scalar multiplies by the reciprocal,
    which is not the rounded quotient."""
    dvec = torch.full((1, 1), float(d), dtype=torch.float32,
                      device=approx.device)
    q = approx / dvec
    t = thr_i[:, None] + thr_j[None, :]
    t = t * 0.05
    t = t * float(slack_rel)
    t = t - float(slack_abs)
    return q > t


# ---------------------------------------------------------------------------
# Tile lists and the operands of kernels COUNT and APPEND
# ---------------------------------------------------------------------------

class TileList:
    """A (K, 2) int32 list of (row tile, column tile) coordinates, checked
    once and, for a CUDA ``device``, copied to the card once, so each sweep
    over it (:func:`sweep_extract`, ``pallas_pairwise.count_tiles``) does no
    host work per tile. ``tiles[a:b]`` is the range [a, b) of the list, a
    view of both copies."""

    def __init__(self, coords, device):
        host = np.ascontiguousarray(coords, dtype=np.int32).reshape(-1, 2)
        if len(host) and host.min() < 0:
            raise ValueError("negative tile coordinates")
        self._set(host, torch.from_numpy(host).to(device)
                  if torch.device(device).type == "cuda" else None)

    def _set(self, host: np.ndarray, dev) -> None:
        self.host, self.dev = host, dev
        # one past the largest row and column tile
        self.ends = tuple(int(x) + 1 for x in host.max(axis=0)) \
            if len(host) else (0, 0)

    def __len__(self) -> int:
        return len(self.host)

    def __getitem__(self, s: slice) -> "TileList":
        if not isinstance(s, slice) or s.step not in (None, 1):
            raise TypeError("a TileList takes a range [a:b] of its tiles")
        part = TileList.__new__(TileList)
        part._set(self.host[s], None if self.dev is None else self.dev[s])
        return part


def tile_list(coords, device) -> TileList:
    """``coords`` itself when it is a :class:`TileList`, else a new one on
    ``device``."""
    return coords if isinstance(coords, TileList) else TileList(coords, device)


def _check_planes(planes: torch.Tensor, name: str,
                  align: int = D_ALIGN) -> None:
    if planes.dtype != torch.int8 or planes.ndim != 3 \
            or not planes.is_contiguous():
        raise ValueError(f"{name} must be a contiguous (P, N, d_pad) int8 "
                         "tensor")
    if planes.shape[2] % align or planes.data_ptr() % 16:
        raise ValueError(f"{name}: d_pad must be a multiple of {align} and "
                         "the data 16-byte aligned")


def _check_thr(thr: torch.Tensor, n: int, name: str) -> None:
    if thr.dtype != torch.float32 or thr.shape != (n,) \
            or not thr.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) float32 tensor")


def check_tiles(planes_i, planes_j, tiles: TileList, tile_r: int,
                tile_c: int) -> None:
    """Raise ValueError unless the tiles of ``tiles`` lie inside the planes
    (rows of planes_i, columns of planes_j) and, for a CUDA launch, the
    list lies on the planes' device."""
    if len(tiles) and (tiles.ends[0] * tile_r > planes_i.shape[1]
                       or tiles.ends[1] * tile_c > planes_j.shape[1]):
        raise ValueError("tile coordinates outside the planes")
    if planes_i.device.type == "cuda" and (
            tiles.dev is None or tiles.dev.device != planes_i.device):
        raise ValueError("the tile list lies on another device than the "
                         "planes")


def check_operands(planes_i, thr_i, planes_j, thr_j, tile_r: int,
                   tile_c: int, d: int, what: str) -> None:
    """Raise ValueError unless kernel COUNT or APPEND (``what``) takes these
    operands: contiguous int8 planes of one P, d_pad and device, float32
    thresholds of their rows, 0 < d <= d_pad, tiles that are multiples of
    128."""
    _check_planes(planes_i, "planes_i")
    _check_planes(planes_j, "planes_j")
    P, ni, d_pad = planes_i.shape
    if planes_j.shape[0] != P or planes_j.shape[2] != d_pad \
            or planes_j.device != planes_i.device:
        raise ValueError("planes_i and planes_j differ in planes, d_pad or "
                         "device")
    if not 0 < d <= d_pad:
        raise ValueError(f"d={d} does not fit d_pad={d_pad}")
    _check_thr(thr_i, ni, "thr_i")
    _check_thr(thr_j, planes_j.shape[1], "thr_j")
    if tile_r % SWEEP_BLOCK or tile_c % SWEEP_BLOCK or tile_r <= 0 \
            or tile_c <= 0:
        raise ValueError(f"kernel {what} takes tiles that are multiples of "
                         f"{SWEEP_BLOCK} (got {tile_r} x {tile_c})")


# ---------------------------------------------------------------------------
# Sweep with survivor compaction (kernel APPEND)
# ---------------------------------------------------------------------------

def launch_sweep(planes_i, thr_i, planes_j, thr_j, tiles, tile_r: int,
                 tile_c: int, d: int, mask_self: bool, cap: int = 0,
                 diag_offset: int = 0, slack_rel: float = SLACK_REL,
                 slack_abs: float = SLACK_ABS):
    """Launch kernel APPEND over ``tiles`` (a :class:`TileList` on the
    planes' device, or a range of one; (K, 2) row/column tile indices in
    units of tile_r / tile_c are copied into a new one) -> (counts (K,)
    int32, rc (cap, 2) int32, total (1,) int32), on the device.
    mask_self drops row == column + diag_offset (operand-local indices);
    slack_rel / slack_abs widen the retention test (:func:`retention_mask`)."""
    dev = planes_i.device
    check_operands(planes_i, thr_i, planes_j, thr_j, tile_r, tile_c, d,
                   "APPEND")
    if cap < 0:
        raise ValueError(f"cap={cap}: the survivor buffer cannot be negative")
    tiles = tile_list(tiles, dev)
    check_tiles(planes_i, planes_j, tiles, tile_r, tile_c)
    P, ni, d_pad = planes_i.shape
    K = len(tiles)
    counts = torch.zeros(K, dtype=torch.int32, device=dev)
    rc = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    if K == 0:
        return counts, rc, total
    w = plane_weights(limbs_from_planes(P))
    lib = _build.library()
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_append(
            planes_i.data_ptr(), planes_j.data_ptr(), thr_i.data_ptr(),
            thr_j.data_ptr(), P, d, d_pad, ni, planes_j.shape[1],
            tiles.dev.data_ptr(), K, tile_r, tile_c,
            w.ctypes.data_as(ctypes.c_void_p), float(slack_rel),
            float(slack_abs), int(mask_self), int(diag_offset),
            counts.data_ptr(), rc.data_ptr(), total.data_ptr(), int(cap),
            stream)
    _build.check(err, "append kernel")
    _build.count_launch("sweep")
    return counts, rc, total


def sweep_extract_plain(planes_i, thr_i, planes_j, thr_j, coords, tile: int,
                        cap: int, mask_self: bool, d: int,
                        diag_offset: int = 0, slack_rel: float = SLACK_REL,
                        slack_abs: float = SLACK_ABS):
    """Plain PyTorch version of :func:`sweep_extract` (survivors in tile
    order, row-major within a tile)."""
    dev = planes_i.device
    if isinstance(coords, TileList):
        coords = coords.host
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    counts = torch.zeros(len(coords), dtype=torch.int32, device=dev)
    found = []
    ar = torch.arange(tile, device=dev)
    for k, (r, c) in enumerate(coords.tolist()):
        rows = slice(r * tile, (r + 1) * tile)
        cols = slice(c * tile, (c + 1) * tile)
        m = retention_mask(approx_dot_f32(planes_i[:, rows], planes_j[:, cols]),
                           thr_i[rows], thr_j[cols], d, slack_rel, slack_abs)
        if mask_self:
            m &= (r * tile + ar)[:, None] != \
                (c * tile + diag_offset + ar)[None, :]
        nz = m.nonzero()
        counts[k] = nz.shape[0]
        found.append(nz + torch.tensor([r * tile, c * tile], device=dev))
    allrc = torch.cat(found) if found else \
        torch.empty((0, 2), dtype=torch.int64, device=dev)
    rc = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
    keep = min(cap, allrc.shape[0])
    rc[:keep] = allrc[:keep].to(torch.int32)
    total = torch.tensor([allrc.shape[0]], dtype=torch.int32, device=dev)
    return rc, counts, total


def sweep_extract(planes_i, thr_i, planes_j, thr_j, coords, tile: int,
                  cap: int, mask_self: bool, d: int, diag_offset: int = 0,
                  slack_rel: float = SLACK_REL, slack_abs: float = SLACK_ABS):
    """Survivors of the tiles ``coords`` (a :class:`TileList`, or a range
    ``tiles[a:b]`` of one, of row/column tile indices of edge ``tile`` into
    planes_i / planes_j; a (K, 2) array is copied into a new list) -> (rc
    (cap, 2) int32 survivor (row, column) pairs, operand-local, counts (K,)
    int32 per-tile survivor counts, total (1,) int32 survivors in all): ONE
    launch of kernel APPEND on CUDA, the plain version on the CPU (over the
    list's host copy).

    Only the first min(total, cap) rows of rc are written; total and counts
    are exact past cap, so the caller can rerun at the exact capacity.
    mask_self drops the self-pairs: row == column + diag_offset, where
    diag_offset is planes_j's first global row minus planes_i's (0 when the
    two share one row numbering). The CUDA order of survivors is
    unspecified (atomics); the plain version's is tile order, row-major.
    slack_rel / slack_abs: the retention test's widening (the engine's by
    default; 1 and 0 for the raw test)."""
    if planes_i.device.type == "cpu":
        return sweep_extract_plain(planes_i, thr_i, planes_j, thr_j, coords,
                                   tile, cap, mask_self, d, diag_offset,
                                   slack_rel, slack_abs)
    counts, rc, total = launch_sweep(planes_i, thr_i, planes_j, thr_j,
                                     coords, tile, tile, d,
                                     mask_self=mask_self, cap=cap,
                                     diag_offset=diag_offset,
                                     slack_rel=slack_rel,
                                     slack_abs=slack_abs)
    return rc, counts, total


# ---------------------------------------------------------------------------
# Scores of query planes against one database chunk (kernel S, SCORE)
# ---------------------------------------------------------------------------

def scan_scores_plain(q_planes: torch.Tensor, db_planes: torch.Tensor,
                      inv_n: torch.Tensor, valid: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`scan_scores`."""
    score = approx_dot_f32(q_planes, db_planes) * inv_n[None, :]
    lane = torch.arange(db_planes.shape[1], device=score.device)
    return score.masked_fill(lane[None, :] >= valid, float("-inf"))


def scan_scores(q_planes: torch.Tensor, db_planes: torch.Tensor,
                inv_n: torch.Tensor, valid: int) -> torch.Tensor:
    """(P, B, d_pad) int8 query planes x (P, R, d_pad) int8 planes of one
    database chunk -> (B, R) float32 ranking scores: the plane-order f32
    combine of the exact plane products (:func:`approx_dot_f32`) times
    inv_n (R,) float32, -inf on lanes >= valid.

    On CUDA B and R must be multiples of 128 (:func:`pad_rows`): pad query
    rows with zero planes and drop their scores; pad database rows with
    zero planes, inv_n 0 and a valid count that excludes them."""
    if q_planes.device.type == "cpu":
        return scan_scores_plain(q_planes, db_planes, inv_n, valid)
    _check_planes(q_planes, "q_planes")
    _check_planes(db_planes, "db_planes")
    P, B, d_pad = q_planes.shape
    R = db_planes.shape[1]
    if db_planes.shape[0] != P or db_planes.shape[2] != d_pad \
            or db_planes.device != q_planes.device:
        raise ValueError("q_planes and db_planes differ in planes, d_pad or "
                         "device")
    if B % SWEEP_BLOCK or R % SWEEP_BLOCK:
        raise ValueError(f"kernel S takes row counts that are multiples of "
                         f"{SWEEP_BLOCK} (got {B} x {R})")
    _check_thr(inv_n, R, "inv_n")
    if inv_n.device != q_planes.device:
        raise ValueError("inv_n must lie on the planes' device")
    scores = torch.empty((B, R), dtype=torch.float32, device=q_planes.device)
    w = plane_weights(limbs_from_planes(P))
    lib = _build.library()
    with _build.launch_stream(q_planes.device) as stream:
        err = lib.mvs_scan(
            q_planes.data_ptr(), db_planes.data_ptr(), P, d_pad, B * d_pad,
            R * d_pad, B, R, inv_n.data_ptr(), int(max(0, min(valid, R))),
            w.ctypes.data_as(ctypes.c_void_p), scores.data_ptr(), R, stream)
    _build.check(err, "scan kernel")
    _build.count_launch("scan")
    return scores


# ---------------------------------------------------------------------------
# Exact limb-pair partials of candidate pairs (kernel X)
# ---------------------------------------------------------------------------

def pair_partials_plain(planes: torch.Tensor, rc: torch.Tensor, L: int,
                        planes_j: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`pair_partials`."""
    planes_j = planes if planes_j is None else planes_j
    xs, ys = planes[:L], planes_j[:L]
    d_pad = planes.shape[2]
    n = rc.shape[0]
    out = torch.empty((n, num_planes(L)), dtype=torch.int32,
                      device=planes.device)
    chunk = max(1, (64 << 20) // (8 * L * d_pad))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        x = xs[:, rc[s:e, 0].long()].to(torch.int32)        # (L, k, d_pad)
        y = ys[:, rc[s:e, 1].long()].to(torch.int32)
        cols = [(x[a] * y[a]).sum(-1) for a in range(L)]
        cols += [(x[a] * y[b] + x[b] * y[a]).sum(-1)
                 for a in range(L) for b in range(a + 1, L)]
        out[s:e] = torch.stack(cols, dim=1).to(torch.int32)
    return out


def range_flag(device) -> torch.Tensor:
    """A zeroed (1,) int32 counter on ``device`` into which kernel X counts
    the candidates outside its operands' rows (:func:`pair_partials`); one
    flag may serve many launches."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def check_range_flag(flag: torch.Tensor) -> None:
    """Raise ValueError if kernel X met out-of-range candidates. Reads the
    flag to the host: call it where the caller synchronises anyway."""
    bad = int(flag.item())
    if bad:
        raise ValueError(f"{bad} candidate pair(s) had rows/columns outside "
                         "the planes")


def pair_partials(planes: torch.Tensor, rc: torch.Tensor, L: int,
                  planes_j: torch.Tensor | None = None,
                  flag: torch.Tensor | None = None) -> torch.Tensor:
    """Exact int32 limb-pair partial dots of candidate pairs rc ((n, 2)
    int32: a row of planes, a row of planes_j — planes itself when
    planes_j is None; the first L planes of each are the limbs)
    -> (n, L(L+1)/2) int32: D_aa for a < L, then D_ab + D_ba for a < b —
    the order pairwise_math.combine_plane_partials takes (transposed).

    Out-of-range candidates raise ValueError: on the CPU here; on CUDA the
    kernel counts them into ``flag`` (:func:`range_flag`, required) and
    leaves their output rows unwritten, and :func:`check_range_flag`
    raises where the caller reads the flag, so the call itself never
    waits for the device."""
    if planes.device.type == "cpu":
        nj = (planes if planes_j is None else planes_j).shape[1]
        r, c = rc[:, 0], rc[:, 1]
        if rc.shape[0] and bool(((r < 0) | (r >= planes.shape[1]) | (c < 0)
                                 | (c >= nj)).any()):
            raise ValueError(f"candidate rows/columns outside [0, "
                             f"{planes.shape[1]}) x [0, {nj})")
        return pair_partials_plain(planes, rc, L, planes_j)
    planes_j = planes if planes_j is None else planes_j
    _check_planes(planes, "planes", 16)     # kernel X reads 16-byte steps
    _check_planes(planes_j, "planes_j", 16)
    P, ni, d_pad = planes.shape
    nj = planes_j.shape[1]
    if planes_j.shape[2] != d_pad or planes_j.device != planes.device:
        raise ValueError("planes and planes_j differ in d_pad or device")
    if not 1 <= L <= 5 or num_planes(L) > min(P, planes_j.shape[0]):
        raise ValueError(f"L={L} does not match {P} planes")
    if rc.dtype != torch.int32 or rc.ndim != 2 or rc.shape[1] != 2 \
            or not rc.is_contiguous() or rc.device != planes.device:
        raise ValueError("rc must be a contiguous (n, 2) int32 tensor on the "
                         "planes' device")
    if flag is None or flag.dtype != torch.int32 or flag.numel() != 1 \
            or flag.device != planes.device:
        raise ValueError("flag must be a (1,) int32 tensor on the planes' "
                         "device (range_flag), read with check_range_flag")
    n = rc.shape[0]
    out = torch.empty((n, num_planes(L)), dtype=torch.int32,
                      device=planes.device)
    if n == 0:
        return out
    lib = _build.library()
    with _build.launch_stream(planes.device) as stream:
        err = lib.mvs_partials(planes.data_ptr(), ni * d_pad,
                               planes_j.data_ptr(), nj * d_pad, L, d_pad, ni,
                               nj, rc.data_ptr(), n, out.data_ptr(),
                               flag.data_ptr(), stream)
    _build.check(err, "partials kernel")
    _build.count_launch("partials")
    return out


def exact_dots_device(planes: torch.Tensor, L: int, rows: np.ndarray,
                      cols: np.ndarray,
                      planes_j: torch.Tensor | None = None) -> np.ndarray:
    """Exact int64 dots of candidate pairs from the staged int8 planes
    (JAX ``exact_dots_device``, ops/pairwise.py:930): kernel X's limb-pair
    partials of (rows[k], cols[k]) (a row of planes, a row of planes_j —
    planes itself when None), one device->host copy of 4 * L(L+1)/2 bytes
    a pair, then the host's exact combine. One launch for any number of
    pairs (the caller bounds it)."""
    dev = planes.device
    rc = torch.from_numpy(np.stack([rows, cols], axis=1)
                          .astype(np.int32)).to(dev)
    flag = range_flag(dev) if dev.type == "cuda" else None
    parts = pair_partials(planes, rc, L, planes_j, flag).cpu().numpy()
    if flag is not None:
        check_range_flag(flag)
    return combine_plane_partials(parts.T, L)


# ---------------------------------------------------------------------------
# Exact retention of candidate pairs on the card (kernel X, retention
# epilogue)
# ---------------------------------------------------------------------------

KEPT_BYTES = 16       # a kept pair: row int32, column int32, dot int64
COUNTER_BYTES = 24    # kept, emitted, out of range: int64 each


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array: a CUDA tensor is copied into page-locked
    memory (PyTorch's caching host allocator), waiting for the current
    stream as ``.cpu()`` does; a CPU tensor is returned as it is. The
    fused engine's per-round reads (APPEND's totals and counts, kernel X's
    counters and kept pairs) take this copy."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


@dataclass(frozen=True)
class Retention:
    """One shard's exact retention, the host finalize's
    (matrix.compute._make_finalizer): a pair (r, c) of global rows is kept
    when begin_row <= r < end_row, c < total and the reference's test of
    the db's dtype passes on its exact dot against 0.05 * (ns[r] + ns[c])
    (int32: the truncating int64 division dot / d,
    pairwise_math.exact_filter_int32; int16: the double division,
    exact_filter_int16). ns: the (total,) float64 squared norms, on the
    device of the planes it runs beside."""
    ns: torch.Tensor
    d: int
    int16: bool
    begin_row: int
    end_row: int
    total: int


def pair_keep_plain(planes, rc, L: int, keep: Retention, cap: int,
                    planes_j=None, row_base: int = 0, col_base: int = 0,
                    twins: tuple | None = None):
    """Plain PyTorch version of :func:`pair_keep`: the same steps in int64
    and float64 torch ops; kept pairs in candidate order, every kept pair
    before the kept twins."""
    planes_j = planes if planes_j is None else planes_j
    dev = planes.device
    r, c = rc[:, 0].long(), rc[:, 1].long()
    ok = (r >= 0) & (r < planes.shape[1]) & (c >= 0) & (c < planes_j.shape[1])
    r, c = r[ok], c[ok]
    parts = pair_partials_plain(planes, torch.stack([r, c], 1), L,
                                planes_j).long()
    w = [1 << (14 * a) for a in range(L)]
    w += [1 << (7 * (a + b)) for a in range(L) for b in range(a + 1, L)]
    dot = (parts * torch.tensor(w, dtype=torch.int64, device=dev)).sum(1)
    gr, gc = r + row_base, c + col_base
    in0 = (gr >= keep.begin_row) & (gr < keep.end_row) & (gc < keep.total)
    in1 = torch.zeros_like(in0)
    if twins is not None:
        tile, rt0, rt1 = twins
        ct = gc // tile
        in1 = (ct > gr // tile) & (ct >= rt0) & (ct < rt1) \
            & (gc >= keep.begin_row) & (gc < keep.end_row) & (gr < keep.total)
    need = in0 | in1
    dn, rn, cn = dot[need], gr[need], gc[need]
    thr = 0.05 * (keep.ns[rn] + keep.ns[cn])
    dvec = torch.full((1,), float(keep.d), dtype=torch.float64, device=dev)
    q = dn.double() / dvec if keep.int16 else \
        torch.div(dn, keep.d, rounding_mode="trunc").double()
    passed = torch.zeros_like(need)
    passed[need] = q > thr
    k0, k1 = in0 & passed, in1 & passed
    rows = torch.cat([gr[k0], gc[k1]])
    cols = torch.cat([gc[k0], gr[k1]])
    dots = torch.cat([dot[k0], dot[k1]])
    kept = len(rows)
    out = torch.zeros((cap, 2), dtype=torch.int64, device=dev)
    m = min(cap, kept)
    out[:m, 0] = rows[:m] | (cols[:m] << 32)
    out[:m, 1] = dots[:m]
    counters = torch.tensor([kept, int(in0.sum() + in1.sum()),
                             int((~ok).sum())], dtype=torch.int64,
                            device=dev)
    return out, counters


def pair_keep(planes: torch.Tensor, rc: torch.Tensor, L: int,
              keep: Retention, cap: int,
              planes_j: torch.Tensor | None = None, row_base: int = 0,
              col_base: int = 0, twins: tuple | None = None):
    """Kernel X with its retention epilogue: the exact int64 dots of
    candidate pairs rc ((n, 2) int32: a row of planes, a row of planes_j —
    planes itself when None — whose global rows are row_base + r and
    col_base + c) tested on the card by ``keep``; with twins = (tile, rt0,
    rt1) also the mirror twin (c, r) of each candidate whose column tile
    lies in [rt0, rt1) above its row tile (the resident engine's triangle
    grid), through the same filter and test. ONE launch on CUDA, the plain
    version on the CPU.

    -> (out (cap, 2) int64: kept pairs as (row | column << 32, dot),
    global rows, the first min(kept, cap) written in no fixed order;
    counters (3,) int64: kept, exact past cap, so the caller can rerun at
    the exact capacity; emitted, the pairs (twins included) inside the
    range filter; the candidates outside the planes' rows, which write
    nothing and which :func:`read_kept` raises on), on the planes'
    device. The call itself never waits for the device."""
    if planes.device.type == "cpu":
        return pair_keep_plain(planes, rc, L, keep, cap, planes_j, row_base,
                               col_base, twins)
    planes_j = planes if planes_j is None else planes_j
    _check_planes(planes, "planes", 16)
    _check_planes(planes_j, "planes_j", 16)
    P, ni, d_pad = planes.shape
    nj = planes_j.shape[1]
    dev = planes.device
    if planes_j.shape[2] != d_pad or planes_j.device != dev:
        raise ValueError("planes and planes_j differ in d_pad or device")
    if not 1 <= L <= 5 or num_planes(L) > min(P, planes_j.shape[0]):
        raise ValueError(f"L={L} does not match {P} planes")
    if rc.dtype != torch.int32 or rc.ndim != 2 or rc.shape[1] != 2 \
            or not rc.is_contiguous() or rc.device != dev:
        raise ValueError("rc must be a contiguous (n, 2) int32 tensor on the "
                         "planes' device")
    ns = keep.ns
    if ns.dtype != torch.float64 or ns.ndim != 1 or not ns.is_contiguous() \
            or ns.device != dev or ns.shape[0] < keep.total:
        raise ValueError(f"keep.ns must be a contiguous ({keep.total},) "
                         "float64 tensor on the planes' device")
    if keep.d <= 0 or cap < 0 or row_base < 0 or col_base < 0:
        raise ValueError("d must be positive; cap, row_base and col_base "
                         "not negative")
    tile, rt0, rt1 = twins if twins is not None else (0, 0, 0)
    if twins is not None and tile <= 0:
        raise ValueError(f"twins: tile={tile} must be positive")
    out = torch.empty((cap, 2), dtype=torch.int64, device=dev)
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    n = rc.shape[0]
    if n == 0:
        return out, counters
    lib = _build.library()
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_keep(planes.data_ptr(), ni * d_pad, planes_j.data_ptr(),
                           nj * d_pad, L, d_pad, ni, nj, rc.data_ptr(), n,
                           ns.data_ptr(), int(row_base), int(col_base),
                           int(keep.begin_row), int(keep.end_row),
                           int(keep.total), int(keep.d), int(keep.int16),
                           int(tile), int(rt0), int(rt1), out.data_ptr(),
                           int(cap), counters.data_ptr(), stream)
    _build.check(err, "keep kernel")
    _build.count_launch("keep")
    return out, counters


def read_kept(out: torch.Tensor, counters) -> tuple:
    """The host's copy of :func:`pair_keep`'s kept pairs: ``counters``, read
    to the host already ((3,) int64 array), says how many; raises
    ValueError on out-of-range candidates and RuntimeError when out holds
    fewer than were kept (rerun at the exact capacity first) -> (rows,
    cols, dots) int64 arrays, the bytes copied (the counters' included)."""
    kept, _, bad = (int(x) for x in counters)
    if bad:
        raise ValueError(f"{bad} candidate pair(s) had rows/columns outside "
                         "the planes")
    if kept > out.shape[0]:
        raise RuntimeError(f"{kept} kept pairs in a buffer of {out.shape[0]}")
    rec = to_host(out[:kept])
    rc32 = rec.view(np.int32).reshape(kept, 4)
    return ((rc32[:, 0].astype(np.int64), rc32[:, 1].astype(np.int64),
             rec[:, 1].copy()), kept * KEPT_BYTES + COUNTER_BYTES)
