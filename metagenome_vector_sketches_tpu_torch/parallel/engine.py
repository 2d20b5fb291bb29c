"""Mesh-sharded device calls of the pairwise engine (JAX
``parallel/engine.py``).

One shard's tile grid is data-parallel over a :class:`~.mesh.Mesh`: the
Karatsuba planes and thresholds are replicated to every slot, the tile
coordinates are split once into one contiguous block per slot, each a tile
list on its slot's card (:meth:`MeshSweepOps.tile_lists`), and every slot
runs the single-device kernels on a range of its own list: kernel APPEND
and then kernel X with its retention epilogue on its survivors. Every slot
is launched before any is synchronised; each slot reruns its own range at
its exact capacity when its survivors (kernel APPEND) or its kept pairs
(kernel X) overflow their buffer (both count past their cap); the slots'
kept pairs come to the host in slot order, with global rows, so the shard
writer does not depend on the slot count. A 1-slot mesh is the
single-device engine.

The two-phase engine's counts sweep is :meth:`MeshSweepOps.sweep_counts`
(kernel COUNT on every slot's block of tiles, JAX ``_counts_fn``, over the
per-slot tile lists of :meth:`MeshSweepOps.tile_lists`); its
hot-tile extraction is :meth:`MeshSweepOps.sweep_extract_fused` with
``mask_self=False``: kernel APPEND compacts the survivors in the sweep
itself, so JAX ``_mask_fn``, ``_compact_fn`` and
``_compact_words_fn`` (bitmaps, index and word compaction) have no
counterpart, nor have the fused engine's ``compact_cands_combined`` /
``split_combined``: each slot's rows reach the host already split.
"""

from __future__ import annotations

import numpy as np

from ..ops import pairwise as pw
from ..ops import pallas_pairwise as pp
from .mesh import Mesh, replicated


class MeshSweepOps:
    """The engine's device calls over ``mesh`` (JAX ``MeshSweepOps``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_devices = mesh.size

    # -- staging ------------------------------------------------------------
    def replicate(self, *tensors):
        """Each tensor on every slot's device -> one tuple of per-slot
        tensors per argument (the tensor itself where a slot shares its
        device)."""
        out = tuple(replicated(self.mesh, t) for t in tensors)
        return out if len(out) > 1 else out[0]

    # -- helpers ------------------------------------------------------------
    def _pad(self, coords: np.ndarray) -> tuple[list, int]:
        """-> (per-slot contiguous blocks of coords, len(coords)): the
        blocks of JAX ``_pad`` (ceil(t / n) tiles each, the last ones
        shorter); its pad tiles are not launched, the kernels take any
        count."""
        coords = np.asarray(coords, dtype=np.int32).reshape(-1, 2)
        t = coords.shape[0]
        k_loc = -(-t // self.n_devices)
        return [coords[s * k_loc:(s + 1) * k_loc]
                for s in range(self.n_devices)], t

    # -- the engine's device calls ------------------------------------------
    def tile_lists(self, coords) -> list:
        """``coords`` split into :meth:`_pad`'s per-slot blocks, each a
        :class:`~..ops.pairwise.TileList` on its slot's device (None for an
        empty block): the sweeps' coordinates, checked and copied to the
        card once per list, however many sweeps read them."""
        blocks, _ = self._pad(coords)
        return [pw.TileList(b, self.mesh.devices[s]) if len(b) else None
                for s, b in enumerate(blocks)]

    def sweep_counts(self, planes, thr, lists, tile: int, d: int,
                     planes_j=None, thr_j=None) -> np.ndarray:
        """Kernel COUNT (:func:`~..ops.pallas_pairwise.count_tiles`) on
        every slot's tile list (:meth:`tile_lists`), every slot launched
        before any is read -> the (T,) int64 per-tile survivor counts on
        the host, in coordinate order (JAX ``MeshSweepOps.sweep_counts``):
        one device->host copy of each slot's counts. planes/thr
        (planes_j/thr_j: the column operand, default the same) are
        per-slot replicas."""
        planes_j = planes if planes_j is None else planes_j
        thr_j = thr if thr_j is None else thr_j
        m = self.mesh
        runs = []
        for s, tiles in enumerate(lists):
            if tiles is not None:
                with m.slot(s):
                    runs.append((s, pp.count_tiles(planes[s], thr[s],
                                                   planes_j[s], thr_j[s],
                                                   tiles, tile, d)))
        out = []
        for s, counts in runs:
            with m.slot(s):
                out.append(counts.cpu().numpy().astype(np.int64))
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)

    def sweep_extract_fused(self, planes, thr, lists, tile: int, cap: int,
                            d: int, max_pairs: int, planes_j=None, thr_j=None,
                            diag_offset: int = 0, mask_self: bool = True,
                            first: int = 0, count: int | None = None):
        """Kernel APPEND (self-pairs masked unless ``mask_self`` is False,
        as the two-phase engine's extraction keeps them) on every slot's
        tiles [first, first + count) of its tile list (``lists``:
        :meth:`tile_lists`; the whole lists by default), then each slot
        whose survivors overflow ``cap`` rerun at its exact count.
        planes/thr (planes_j/thr_j: the column operand, default the same)
        are per-slot replicas (:meth:`replicate`).

        -> None when a slot of more than one tile found more than
        ``max_pairs`` survivors (the caller halves its round), else (a list
        of per-slot (rc (cap_s, 2) int32, n_s) on the slots' devices, None
        for a slot without tiles in the range; the per-tile survivor counts
        of the swept tiles on the host, int32, slot after slot: the lists'
        order), after each slot's stream finished its sweep."""
        planes_j = planes if planes_j is None else planes_j
        thr_j = thr if thr_j is None else thr_j
        stop = None if count is None else first + count
        parts = {s: tiles[first:stop] for s, tiles in enumerate(lists)
                 if tiles is not None}
        live = [s for s, tiles in parts.items() if len(tiles)]
        m = self.mesh

        def launch(s, c):
            with m.slot(s):
                return pw.sweep_extract(planes[s], thr[s], planes_j[s],
                                        thr_j[s], parts[s], tile, c,
                                        mask_self, d, diag_offset)

        runs = {s: launch(s, cap) for s in live}
        totals, counts = {}, []
        for s in live:
            with m.slot(s):
                totals[s] = int(pw.to_host(runs[s][2])[0])
                counts.append(pw.to_host(runs[s][1]))
        if any(totals[s] > cap and totals[s] > max_pairs
               and len(parts[s]) > 1 for s in live):
            return None
        over = [s for s in live if totals[s] > cap]
        reruns = {s: launch(s, totals[s]) for s in over}
        for s in over:
            with m.slot(s):
                got = int(pw.to_host(reruns[s][2])[0])
            if got != totals[s]:
                raise RuntimeError(f"sweep rerun on slot {s} found {got} "
                                   f"survivors, the first run {totals[s]}")
            runs[s] = reruns[s]
        return ([(runs[s][0], totals[s]) if s in runs else None
                 for s in range(m.size)],
                np.concatenate(counts) if counts
                else np.zeros(0, dtype=np.int32))

    def pair_keep(self, planes, swept, L: int, keeps, cap: int,
                  planes_j=None, row_base: int = 0, col_base: int = 0,
                  twins: tuple | None = None):
        """Kernel X with its retention epilogue
        (:func:`~..ops.pairwise.pair_keep`) on every slot's survivors
        (``swept``: the per-slot list of :meth:`sweep_extract_fused`), with
        ``keeps`` the per-slot :class:`~..ops.pairwise.Retention` (its
        norms on the slot's card): all slots launched first, then one
        device->host copy of each slot's counters; a slot that kept more
        than ``cap`` pairs is rerun at its exact count; then one copy of
        each slot's kept pairs, in slot order -> (per slot the host (rows,
        cols, dots) int64 arrays of its kept pairs, global rows, None for
        an empty slot; the pairs inside the range filter, twins included,
        summed over the slots; the bytes copied to the host)."""
        planes_j = planes if planes_j is None else planes_j
        m = self.mesh

        def launch(s, c):
            rc, n = swept[s]
            with m.slot(s):
                return pw.pair_keep(planes[s], rc[:n], L, keeps[s], c,
                                    planes_j[s], row_base, col_base, twins)

        runs = {s: launch(s, cap) for s, run in enumerate(swept)
                if run is not None}
        counts = {}
        for s in runs:
            with m.slot(s):
                counts[s] = pw.to_host(runs[s][1])
        over = [s for s in runs if counts[s][0] > cap]
        for s in over:
            runs[s] = launch(s, int(counts[s][0]))
            with m.slot(s):
                got = pw.to_host(runs[s][1])
            if not np.array_equal(got, counts[s]):
                raise RuntimeError(f"kernel X's rerun on slot {s} counted "
                                   f"{got.tolist()}, the first run "
                                   f"{counts[s].tolist()}")
        out = [None] * m.size
        emitted, nbytes = 0, pw.COUNTER_BYTES * len(over)
        for s in runs:
            with m.slot(s):
                out[s], b = pw.read_kept(runs[s][0], counts[s])
            emitted += int(counts[s][1])
            nbytes += b
        return out, emitted, nbytes

    def host_pairs(self, swept) -> list:
        """One device->host copy of every slot's survivor pairs
        (``swept``: the per-slot list of :meth:`sweep_extract_fused`), in
        slot order -> per slot a host (n_s, 2) int32 array of operand-local
        (row, column) pairs (None for an empty slot)."""
        out = []
        for s, run in enumerate(swept):
            if run is None:
                out.append(None)
                continue
            with self.mesh.slot(s):
                out.append(run[0][:run[1]].cpu().numpy())
        return out

    def block_total_max(self, per_tile_counts) -> int:
        """Max over slots of the summed counts in that slot's contiguous
        tile block (:meth:`_pad`'s blocks): the per-slot capacity basis.
        Sizing from the global total would give every slot the whole
        round's buffer."""
        c = np.asarray(per_tile_counts, dtype=np.int64)
        n = self.n_devices
        k_pad = ((len(c) + n - 1) // n) * n
        padded = np.zeros(k_pad, dtype=np.int64)
        padded[:len(c)] = c
        return int(padded.reshape(n, -1).sum(axis=1).max())
