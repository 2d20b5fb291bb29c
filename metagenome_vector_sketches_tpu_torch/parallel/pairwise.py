"""Sharded all-vs-all sweep statistics and the distributed flat-IP top-k
(JAX ``parallel/pairwise.py``).

Each slot of the mesh owns a row block. The column side is gathered: across
the process's slots onto each slot's device, across processes with the
mesh's ``torch.distributed`` all-gather. The sweep statistic runs kernel
APPEND (self-pairs kept) on each slot's rows against every row
and counts each row's survivors with ``torch.bincount``: the per-row count
the JAX program takes with a masked sum. The top-k's local stage is a
plain float32 ``torch.matmul`` with TF32 off (outside any Pallas kernel in
the JAX package too), then a local top-k, a gather of the k candidates and
a re-top-k, each on kernel K, with the JAX tie order (lowest index first,
``ann.select``).

A function returns THIS process's rows (the JAX programs return a
row-sharded global array; with one process that is every row), on the
mesh's first slot.
"""

from __future__ import annotations

import torch

from ..ann.flat_index import fp32_matmul
from ..ann.select import (key_index, key_scores, rank_keys, select_chunk,
                          select_keys)
from ..ops import pairwise as pw
from ..ops import pairwise_math as pm
from .mesh import Mesh, row_sharding

# first capacity (pairs) of a count sweep's survivor buffer; a launch that
# finds more is rerun at its exact count (kernel APPEND counts past its
# cap)
COUNT_CAP_START = 1 << 20
# index of a candidate that is no row (a masked pad): ranks after every
# row among equal scores and decodes to -1
_NONE = (1 << 32) - 1


def _blocks(mesh: Mesh, x, dim: int) -> list:
    """Per-slot blocks of x: x itself when it is already a list of them,
    else x split along ``dim`` (:func:`.mesh.row_sharding`)."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} blocks for a mesh of {mesh.size} "
                             "slots")
        return [b.to(d) for b, d in zip(x, mesh.devices)]
    return row_sharding(mesh, torch.as_tensor(x), dim)


def _count_tile(n: int, dev: torch.device) -> int:
    """Tile edge of a count sweep over n rows: a multiple of the kernels'
    block on CUDA, at most 1,024."""
    return min(1024, pw.pad_rows(max(1, n), dev))


def _sweep_operand(limbs: torch.Tensor, thr: torch.Tensor, rows: int):
    """(L, n, d) int8 limbs and (n,) float32 thresholds -> ((P, rows,
    d_pad) int8 planes, (rows,) float32 thresholds) on the limbs' device:
    zero planes and threshold 1e30 on the pad rows, which never pass."""
    L, n, d = limbs.shape
    dev = limbs.device
    planes = torch.zeros((pm.num_planes(L), rows, pw.pad_dim(d)),
                         dtype=torch.int8, device=dev)
    pw.planes_update(planes, limbs, 0)
    t = torch.full((rows,), 1e30, dtype=torch.float32, device=dev)
    t[:n] = thr.to(device=dev, dtype=torch.float32)
    return planes, t


class _CountSweep:
    """Per-row survivor counts of the rows of one limb block against the
    columns of another under the retention test with slack_rel/slack_abs
    (self-pairs kept), in two steps so that a mesh launches every slot
    before it waits for any: :meth:`launch` enqueues kernel APPEND,
    :meth:`finish` reads the survivor total, reruns at the exact capacity
    when the buffer overflowed, and counts the survivors' rows."""

    def __init__(self, limbs_r, thr_r, limbs_c, thr_c, d: int,
                 slack_rel: float, slack_abs: float):
        dev = limbs_r.device
        self.n = limbs_r.shape[1]
        n_c = limbs_c.shape[1]
        self.tile = _count_tile(max(self.n, n_c), dev)
        nt_r = -(-self.n // self.tile)
        nt_c = -(-n_c // self.tile)
        self.a = _sweep_operand(limbs_r, thr_r, nt_r * self.tile)
        self.b = _sweep_operand(limbs_c.to(dev), thr_c, nt_c * self.tile)
        if nt_r * nt_c * self.tile ** 2 >= 2 ** 31:
            raise ValueError(f"{self.n} x {n_c} pairs exceed one count "
                             "sweep (kernel APPEND counts in 32 bits)")
        self.tiles = pw.TileList([(r, c) for r in range(nt_r)
                                  for c in range(nt_c)], dev)
        self.d, self.slack = d, (slack_rel, slack_abs)
        self.run = None

    def launch(self, cap: int = COUNT_CAP_START):
        self.run = pw.sweep_extract(*self.a, *self.b, self.tiles, self.tile,
                                    cap, False, self.d, 0, *self.slack)
        return self

    def finish(self) -> torch.Tensor:
        rc, _, total = self.run
        n = int(total.item())
        if n > rc.shape[0]:
            rc, _, total = self.launch(n).run
            if int(total.item()) != n:
                raise RuntimeError(f"count sweep rerun found "
                                   f"{int(total.item())} survivors, the "
                                   f"first run {n}")
        rows = rc[:n, 0].to(torch.int64)
        return torch.bincount(rows, minlength=self.n)[:self.n] \
            .to(torch.int32)


def slot_counts(mesh: Mesh, limb_blocks: list, thr_blocks: list,
                limbs_all: torch.Tensor, thr_all: torch.Tensor, d: int,
                slack_rel: float, slack_abs: float) -> torch.Tensor:
    """Per-row survivor counts of every slot's rows against the gathered
    columns (limbs_all, thr_all), each slot's sweep launched on its own
    stream before any is read -> (rows of this process,) int32 on the lead
    device, in slot order."""
    sweeps = []
    for s, dev in enumerate(mesh.devices):
        with mesh.slot(s):
            sweeps.append(_CountSweep(limb_blocks[s], thr_blocks[s],
                                      limbs_all.to(dev), thr_all.to(dev), d,
                                      slack_rel, slack_abs).launch())
    counts = []
    for s, sw in enumerate(sweeps):
        with mesh.slot(s):
            counts.append(sw.finish())
    return mesh.gather_slots(counts)


def sharded_pairwise_counts(mesh: Mesh, v_limbs, thr, d: int) -> torch.Tensor:
    """One full sharded sweep: per-row SWEEP-candidate counts under the
    engine's widened retention threshold (SLACK_REL / SLACK_ABS, a
    certified superset of the exact retention), self-pairs included.

    v_limbs: (L, N, d) int8 balanced limbs (``ops.pairwise.decompose_limbs``)
    of this process's rows, split over the slots on axis 1 (or the list of
    per-slot blocks); thr: (N,) float32 squared norms, split the same way.
    Limbs, not planes, are gathered: each slot rebuilds the Karatsuba
    planes after the gather, as the JAX program does.

    -> (N,) int32 per-row survivor counts of this process's rows, on the
    lead device."""
    limb_blocks = _blocks(mesh, v_limbs, 1)
    thr_blocks = _blocks(mesh, thr, 0)
    limbs_all = mesh.all_gather(mesh.gather_slots(limb_blocks, 1), 1)
    thr_all = mesh.all_gather(mesh.gather_slots(thr_blocks))
    return slot_counts(mesh, limb_blocks, thr_blocks, limbs_all, thr_all, d,
                       float(pm.SLACK_REL), float(pm.SLACK_ABS))


def _pad_keys(top: torch.Tensor, k: int) -> torch.Tensor:
    """top padded with no-row keys (-inf, index none) to k columns."""
    if top.shape[1] >= k:
        return top
    pad = rank_keys(torch.full((top.shape[0], k - top.shape[1]),
                               float("-inf"), device=top.device),
                    torch.tensor(_NONE, device=top.device))
    return torch.cat([top, pad], dim=1)


def topk_keys(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k best keys of each row (``ann.select`` keys; kernel K), padded
    with no-row keys (-inf, index none) to k when a row holds fewer."""
    return _pad_keys(select_keys(keys, k)[0], k)


def decode_keys(keys: torch.Tensor):
    """-> (scores float32, indices int64 with -1 for no row)."""
    idx = key_index(keys)
    return key_scores(keys), torch.where(idx == _NONE, -1, idx)


def distributed_topk(mesh: Mesh, queries, v_norm, k: int,
                     n_valid: int | None = None,
                     recall_target: float = 1.0, row_ids=None):
    """Distributed flat-IP top-k: database rows split over the slots (and
    processes), queries replicated; each slot's float32 product and local
    top-k, then a gather of the n_slots * k candidates and a re-top-k.

    queries: (B, d) float32. v_norm: (N, d) float32 L2-normalised rows of
    this process, split over the slots on axis 0 (or the list of per-slot
    blocks). n_valid: the true row count when v_norm carries pad rows, which
    then score -inf (they never displace a real neighbour, even one of
    negative score). row_ids: explicit (N,) int global ids, -1 for a pad
    row, split like v_norm (per-process row layouts); the emitted indices
    are these ids. recall_target < 1 selects exactly too (the port has no
    approximate selector).

    -> (D (B, k) float32, I (B, k) int64 global rows, -1 past the real
    matches, whose D is -inf), on the lead device; among equal scores the
    lowest index comes first."""
    v_blocks = _blocks(mesh, v_norm, 0)
    id_blocks = None if row_ids is None else _blocks(mesh, row_ids, 0)
    q = torch.as_tensor(queries, dtype=torch.float32)
    rows = v_blocks[0].shape[0]
    parts = []
    with fp32_matmul():
        for s, dev in enumerate(mesh.devices):
            with mesh.slot(s):
                v = v_blocks[s]
                scores = q.to(dev) @ v.T
                if id_blocks is not None:
                    ids = id_blocks[s].to(torch.int64)
                    ok = ids >= 0
                    scores = scores.masked_fill(~ok[None, :], float("-inf"))
                    parts.append(topk_keys(rank_keys(
                        scores, torch.where(ok, ids, _NONE)), k))
                    continue
                # rows base .. base + valid - 1 are real, the rest pad rows
                base = (mesh.process_index * mesh.size + s) * rows
                valid = v.shape[0] if n_valid is None \
                    else max(0, min(n_valid - base, v.shape[0]))
                if valid < v.shape[0]:
                    lane = torch.arange(v.shape[0], device=dev)
                    scores = scores.masked_fill(lane[None, :] >= valid,
                                                float("-inf"))
                top = select_chunk(scores, base, valid, _NONE,
                                   min(k, v.shape[0]),
                                   torch.empty((scores.shape[0], 0),
                                               dtype=torch.int64, device=dev),
                                   k)[0]
                parts.append(_pad_keys(top, k))
    merged = topk_keys(mesh.all_gather(mesh.gather_slots(parts, dim=1),
                                       dim=1), k)
    return decode_keys(merged)
