"""Distributed ANN indexes over a mesh (JAX ``ann/distributed.py``).

DistributedFlatIPIndex: database rows split over the mesh's slots (and
processes), queries replicated; each slot's float32 product and top-k,
merged with a gather and a re-top-k (``parallel.pairwise.distributed_topk``).
A drop-in for FlatIPIndex.search.

DistributedIntExactIndex: the int8-plane exact engine's chunk stack split
over the slots on the chunk axis; each slot scans its own chunks with
global indices (kernel S SCORE, then kernel X on its pooled pairs), then
the slots' candidate pools (scores, indices AND exact plane partials) are
gathered (over the slots, then over processes) and re-selected at the full
pool. The host finalize (exact int64 dots, float64 cosine ranking) is the
single-device engine's, so the results are identical to it. Among equal
scores the lowest index comes first (the int64 keys of ``ann.select``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pairwise as pw
from ..ops import pairwise_math as pm
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.pairwise import decode_keys, distributed_topk
from .flat_index import FlatIPIndex
from .int_index import (IntExactIndex, _dbfolder_staging, _int_scan_pool,
                        _inv_norms, chunk_layout)
from .select import rank_keys, select_keys


def _mesh_for(mesh, device) -> Mesh:
    """The caller's mesh, else every local device of ``device``'s type."""
    return mesh if mesh is not None else make_mesh(device=device)


def _per_process(mesh: Mesh, values) -> np.ndarray:
    """Every process's int64 values (the same count on each) as an
    (n_proc, len(values)) host array, in process order (one all-gather)."""
    t = torch.tensor(np.asarray(values, dtype=np.int64).reshape(1, -1))
    return mesh.all_gather(t, dim=0).cpu().numpy()


class DistributedFlatIPIndex:
    """Exact inner-product top-k over L2-normalised float32 vectors whose
    rows are split over the mesh. recall_target is kept for the interface:
    the port selects exactly."""

    def __init__(self, vectors: np.ndarray, mesh: Mesh | None = None,
                 recall_target: float = 1.0, *, device=None):
        """vectors: (n, d) float32 L2-normalised. Rows are padded with zero
        rows to a multiple of the mesh's slots of all processes; the pad
        rows score -inf in every search. Every process passes the same
        vectors and keeps its own block (mesh: the caller's, else every
        local device of ``device``'s type)."""
        self.mesh = _mesh_for(mesh, device)
        V = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = V.shape
        G = self.mesh.global_size
        rows_pp = -(-n // G) * self.mesh.size
        padded = np.zeros((rows_pp * self.mesh.process_count, d),
                          dtype=np.float32)
        padded[:n] = V
        own = padded[self.mesh.process_index * rows_pp:][:rows_pp]
        self._place(own, (n, d), None, recall_target)

    def _place(self, rows: np.ndarray, shape, ids, recall_target):
        """This process's (rows_pp, d) rows (and row ids) onto the slots."""
        m = self.mesh
        self._shape = tuple(int(x) for x in shape)
        self.recall_target = float(recall_target)
        b = rows.shape[0] // m.size
        self._v = [torch.from_numpy(rows[s * b:(s + 1) * b]).to(dev)
                   for s, dev in enumerate(m.devices)]
        self._row_ids = None if ids is None else [
            torch.from_numpy(ids[s * b:(s + 1) * b]).to(dev)
            for s, dev in enumerate(m.devices)]

    @classmethod
    def from_flat(cls, index: FlatIPIndex, mesh: Mesh | None = None
                  ) -> "DistributedFlatIPIndex":
        """The host vectors of ``index`` over ``mesh`` (default: every
        local device of the index's type)."""
        return cls(index.vectors, mesh=_mesh_for(mesh, index.device),
                   recall_target=index.recall_target)

    @classmethod
    def from_process_shards(cls, vectors_local: np.ndarray, d: int,
                            mesh: Mesh | None = None,
                            recall_target: float = 1.0, *, device=None
                            ) -> "DistributedFlatIPIndex":
        """COLLECTIVE constructor for multi-process runs (call on every
        process): each process contributes only its own L2-normalised
        float32 row block; global row ids follow process order and no
        process holds the whole database. Per-process pad rows sit inside
        the global layout, so searches mask by explicit row ids. On a mesh
        of one process it is the single-process build."""
        self = cls.__new__(cls)
        self.mesh = _mesh_for(mesh, device)
        V = np.ascontiguousarray(vectors_local, dtype=np.float32)
        counts = _per_process(self.mesh, [V.shape[0]])[:, 0]
        pid, size = self.mesh.process_index, self.mesh.size
        rows_pp = -(-max(int(counts.max()), 1) // size) * size
        padded = np.zeros((rows_pp, int(d)), dtype=np.float32)
        padded[:V.shape[0]] = V
        ids = np.full(rows_pp, -1, dtype=np.int64)
        ids[:V.shape[0]] = int(counts[:pid].sum()) + np.arange(V.shape[0])
        self._place(padded, (int(counts.sum()), int(d)), ids, recall_target)
        return self

    @property
    def ntotal(self) -> int:
        return self._shape[0]

    @property
    def d(self) -> int:
        return self._shape[1]

    @property
    def device(self) -> torch.device:
        """Where queries enter and results land: the mesh's first slot."""
        return self.mesh.lead

    def search_device(self, queries_dev: torch.Tensor, k: int):
        """Device-in/device-out search at k_eff = min(k, ntotal) (the
        adaptive search's contract, FlatIPIndex.search_device) -> (D, I
        int64) on the lead device."""
        k_eff = min(k, max(1, self.ntotal))
        return distributed_topk(self.mesh, queries_dev, self._v, k_eff,
                                n_valid=self.ntotal,
                                recall_target=self.recall_target,
                                row_ids=self._row_ids)

    def search(self, queries: np.ndarray, k: int):
        """-> (D (B, k) float32, I (B, k) int32); missing slots are (0, -1)
        like FAISS when k > ntotal."""
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
        D, I = distributed_topk(self.mesh, q.to(self.device), self._v, k,
                                n_valid=self.ntotal,
                                recall_target=self.recall_target,
                                row_ids=self._row_ids)
        D, I = D.cpu().numpy().copy(), I.cpu().numpy()
        bad = ~np.isfinite(D) | (I < 0) | (I >= self.ntotal)
        D[bad] = 0.0
        return D, np.where(bad, -1, I).astype(np.int32)


class DistributedIntExactIndex(IntExactIndex):
    """IntExactIndex with its chunk stack split over a mesh: the same
    search contract (float64-exact cosines), candidate pooling fanned out
    over the slots. Build it from a single-device index
    (:meth:`from_index`), straight from a db folder (:meth:`from_dbfolder`)
    or, on a multi-process run, collectively from per-process row blocks
    (:meth:`from_process_shards`, no process holds the whole db).

    Slot s holds the chunks s * Cl .. (s + 1) * Cl - 1 of this process's
    chunks (JAX's sharding of the padded chunk axis); a pad chunk of JAX's
    layout holds no row, and the port does not store it."""

    def __init__(self, *a, **kw):
        raise TypeError("use DistributedIntExactIndex.from_index(...), "
                        ".from_dbfolder(...) or .from_process_shards(...)")

    def _init_attrs(self, mesh, shape, R, max_abs, L, ns, mode,
                    recall_target, pool_margin=64):
        assert mode in ("exact", "approx"), mode
        self.mesh = mesh
        self.device = mesh.lead
        self._shape = tuple(int(x) for x in shape)
        self.chunk_rows = R
        self.mode = mode
        self.recall_target = float(recall_target)
        self.pool_margin = int(pool_margin)
        self.max_abs = max_abs
        self.L = L
        self.ns = ns

    def _split(self, n_chunks: int, n_slots: int) -> int:
        """Chunks per slot (Cl) when n_chunks are padded to a multiple of
        the slots; slot s then owns chunks [s * Cl, (s + 1) * Cl)."""
        return -(-max(n_chunks, 1) // n_slots)

    @classmethod
    def from_index(cls, index: IntExactIndex, mesh: Mesh | None = None
                   ) -> "DistributedIntExactIndex":
        """Split a built index's chunks over ``mesh`` (default: every local
        device of the index's type). A slot on the index's device views
        the index's own chunks: nothing is copied."""
        mesh = _mesh_for(mesh, index.device)
        self = cls.__new__(cls)
        self._init_attrs(mesh, index._shape, index.chunk_rows, index.max_abs,
                         index.L, index.ns, index.mode, index.recall_target,
                         index.pool_margin)
        C, R = index._stack.shape[0], index.chunk_rows
        Cl = self._split(C, mesh.size)
        bases, valid = chunk_layout(C, R, index.ntotal)
        self._slots = []
        for s, dev in enumerate(mesh.devices):
            lo, hi = min(s * Cl, C), min((s + 1) * Cl, C)
            self._slots.append((index._stack[lo:hi].to(dev),
                                index._inv_n[lo:hi].to(dev), bases[lo:hi],
                                valid[lo:hi]))
        self._pool_rows = mesh.size * Cl * R
        return self

    @classmethod
    def from_dbfolder(cls, db_folder: str, mesh: Mesh | None = None,
                      chunk_rows: int = 65536, mode: str = "exact",
                      recall_target: float = 0.95, *, device=None
                      ) -> "DistributedIntExactIndex":
        """Stage a db folder STRAIGHT into the split chunk stack: each
        chunk's int8 planes are made on the slot that owns it (peak on a
        device: its slots' chunks plus one chunk). Building a single-device
        index first and splitting it (:meth:`from_index`) would hold the
        whole stack on the first card, and on other cards a second copy of
        their part. Single-process meshes (multi-process runs use
        :meth:`from_process_shards`)."""
        mesh = _mesh_for(mesh, device)
        if mesh.group is not None:
            raise ValueError("from_dbfolder stages from one process; on "
                             "multi-process meshes build collectively with "
                             "from_process_shards")
        n, d, max_abs, R, C, ns, chunks = _dbfolder_staging(db_folder,
                                                            chunk_rows)
        self = cls.__new__(cls)
        self._init_attrs(mesh, (n, d), R, max_abs,
                         pm.pick_limbs(max(1, max_abs)), ns, mode,
                         recall_target)
        Cl = self._split(C, mesh.size)
        stacks = [self._plane_stack(min(max(C - s * Cl, 0), Cl), dev)
                  for s, dev in enumerate(mesh.devices)]
        for c, block in chunks:
            s = c // Cl
            with mesh.slot(s):
                self._stage(c % Cl, torch.from_numpy(block)
                            .to(mesh.devices[s]), stacks[s])
        inv = _inv_norms(ns, C, R, stacks[0].shape[2], n)
        self._slots = []
        for s, dev in enumerate(mesh.devices):
            lo, hi = min(s * Cl, C), min((s + 1) * Cl, C)
            self._slots.append((stacks[s], torch.from_numpy(inv[lo:hi])
                                .to(dev), [c * R for c in range(lo, hi)],
                                [min(n - c * R, R) for c in range(lo, hi)]))
        self._pool_rows = mesh.size * Cl * R
        return self

    @classmethod
    def from_process_shards(cls, vectors_local: np.ndarray, d: int,
                            mesh: Mesh | None = None,
                            chunk_rows: int = 65536, mode: str = "exact",
                            recall_target: float = 0.95, *, device=None
                            ) -> "DistributedIntExactIndex":
        """COLLECTIVE constructor for multi-process runs (call on every
        process): each process contributes only its own row block
        (``vectors_local``, (n_local, d) integer; global row ids follow
        process order). The metadata (row counts, max component, the exact
        |v|^2 norms of the host finalize) is exchanged with the mesh's
        all-gather; the int8 plane chunks stay on this process's slots. On
        a mesh of one process it is the single-process build."""
        mesh = _mesh_for(mesh, device)
        V = np.asarray(vectors_local)
        if V.size and V.dtype not in (np.int8, np.int16, np.int32):
            raise ValueError(f"integer vectors required; got {V.dtype}")
        n_local = int(V.shape[0])
        max_abs_local = int(np.max(np.abs(V.astype(np.int64)))) \
            if n_local else 0
        meta = _per_process(mesh, [n_local, max_abs_local])
        n_locals = meta[:, 0]
        n_total = int(n_locals.sum())
        base_p = int(n_locals[:mesh.process_index].sum())
        max_abs = int(meta[:, 1].max())
        pm.check_exact_dot_range(int(d), max(1, max_abs))
        R = int(min(chunk_rows, max(1, n_total)))   # the same everywhere
        self = cls.__new__(cls)
        # ns (the exact norms of every process) is gathered after staging
        self._init_attrs(mesh, (n_total, int(d)), R, max_abs,
                         pm.pick_limbs(max(1, max_abs)), None, mode,
                         recall_target)
        # the same chunk count on every process: the pools' all-gather
        # needs equal shapes
        Cl = self._split(int(max((n_locals + R - 1) // R)), mesh.size)
        c_here = (n_local + R - 1) // R
        stacks = [self._plane_stack(min(max(c_here - s * Cl, 0), Cl), dev)
                  for s, dev in enumerate(mesh.devices)]
        ns_local = np.zeros(mesh.size * Cl * R, dtype=np.int64)
        for c in range(c_here):
            s, e = c * R, min((c + 1) * R, n_local)
            block = np.ascontiguousarray(V[s:e], dtype=np.int32)
            b64 = block.astype(np.int64)
            ns_local[s:e] = np.einsum("ij,ij->i", b64, b64)
            with mesh.slot(c // Cl):
                self._stage(c % Cl, torch.from_numpy(block)
                            .to(mesh.devices[c // Cl]), stacks[c // Cl])
        ns_all = _per_process(mesh, ns_local)
        self.ns = np.concatenate([ns_all[p, :int(n_locals[p])]
                                  for p in range(len(n_locals))])
        inv = _inv_norms(ns_local[:n_local], max(c_here, 1), R,
                         pw.pad_rows(R, mesh.lead), n_local)
        self._slots = []
        for s, dev in enumerate(mesh.devices):
            lo, hi = min(s * Cl, c_here), min((s + 1) * Cl, c_here)
            self._slots.append((stacks[s], torch.from_numpy(inv[lo:hi])
                                .to(dev),
                                [base_p + c * R for c in range(lo, hi)],
                                [min(n_local - c * R, R)
                                 for c in range(lo, hi)]))
        self._pool_rows = mesh.size * Cl * R
        return self

    # -- search --------------------------------------------------------------
    def _pool(self, qp: torch.Tensor, B: int, pool: int, flag):
        """Candidate pooling of the first B rows of the query planes qp
        over every slot's chunks: each slot's scan and pool (all launched
        before any result is gathered), one gather of the slots' pools,
        then one over processes, then the re-selection at the full pool.
        Kernel X's out-of-range count of every slot is added into ``flag``
        (on the lead device). -> (scores, indices, partials), see
        :func:`.int_index._int_scan_pool`."""
        m = self.mesh
        n = self.ntotal
        P = pm.num_planes(self.L)
        keys, parts, flags = [], [], []
        for s, dev in enumerate(m.devices):
            stack, inv, bases, valid = self._slots[s]
            if not len(bases):
                continue
            with m.slot(s):
                f = pw.range_flag(dev)
                sc, idx, p = _int_scan_pool(qp.to(dev), B, stack, inv, n,
                                            self.chunk_rows, pool, self.L, f,
                                            bases, valid)
                keys.append(rank_keys(sc, torch.where(idx < 0, n, idx)))
                parts.append(p)
                flags.append((s, f))
        width = min(pool, self._pool_rows)
        lead = m.lead
        if keys:
            live = [s for s, _ in flags]
            k_all = torch.cat([m.handoff(s, k).to(lead)
                               for s, k in zip(live, keys)], dim=1)
            p_all = torch.cat([m.handoff(s, p).to(lead)
                               for s, p in zip(live, parts)], dim=1)
            for s, f in flags:
                flag.add_(m.handoff(s, f).to(lead))
        else:
            k_all = torch.empty((B, 0), dtype=torch.int64, device=lead)
            p_all = torch.empty((B, 0, P), dtype=torch.int32, device=lead)
        # this process's pool at a width every process shares, then the
        # processes' pools, re-selected at the full pool
        k_all, p_all = self._select(k_all, p_all, width, n)
        if m.group is not None:
            k_all = m.all_gather(k_all, dim=1)
            p_all = m.all_gather(p_all, dim=1)
            k_all, p_all = self._select(k_all, p_all,
                                        min(pool, k_all.shape[1]), n)
        sc, idx = decode_keys(k_all)
        return sc, torch.where((idx < 0) | (idx >= n), -1, idx), p_all

    @staticmethod
    def _select(keys, parts, width: int, none: int):
        """The ``width`` best keys of each row, padded with no-row keys
        (-inf, index ``none``), and their partials (zeros on the pad)."""
        B, W = keys.shape
        top, pos = select_keys(keys, width)             # kernel K
        p = torch.gather(parts, 1, pos[:, :, None].expand(-1, -1,
                                                          parts.shape[2]))
        pad = width - top.shape[1]
        if pad > 0:
            top = torch.cat([top, rank_keys(
                torch.full((B, pad), float("-inf"), device=keys.device),
                torch.tensor(none, device=keys.device))], dim=1)
            p = torch.cat([p, p.new_zeros((B, pad, p.shape[2]))], dim=1)
        return top, p
