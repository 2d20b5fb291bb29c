"""Adaptive expanding ANN search (reference jaccard.py:63-224).

Port of ``metagenome_vector_sketches_tpu/ann/search.py``. Query hash sets
are projected with the database's seeded kernel (kernel P), scaled by
1/sqrt(d) and L2-normalised; the index is searched with an expanding
k = 50 * 3^i schedule: queries whose k-th inner product is still above
2j/(1+j) are searched again one level deeper (two when the margin exceeds
0.05 — the reference's estimate heuristic), up to 50 * 3^19. Hits are
rescored to the exact-form Jaccard ip*|q||n| / (|n|^2 + |q|^2 - ip*|q||n|),
filtered > j and sorted descending.

Each round runs one shared scan at the round's largest k for every query
still expanding; a query's own results are the prefix of its own k. Per
round only two numbers per query come to the host (the expansion signals);
each query's final-level hits are filtered on the device (a conservative
float32 Jaccard estimate; the host refilters exactly) and copied once.
With an :class:`~.int_index.IntExactIndex` and the integer queries, the
rounds stay on the device end to end (query planes uploaded once) and the
emitted hits carry float64-exact cosines recombined from kernel X's
partials.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device
from ..io import textparse
from ..io.dbfolder import DbFolder
from ..ops import pairwise as pw
from ..ops import pairwise_math as pm
from ..parallel.mesh import serving_mesh
from ..utils.profiling import entry_span, stage
from .flat_index import FlatIPIndex, normalize_l2

INITIAL_NB_SEARCHES = 50
MAX_LEVELS = 20  # 50 * 3^19 hard cap (jaccard.py:129)

# per-stage wall split (ms) of the LAST adaptive_search call (the JAX keys),
# each wall with the profiler span that times the same block
# (utils.profiling.stage):
# - total_ms (mvs.search.adaptive): the whole call;
# - prep_ms (mvs.search.prep): the queries' staging and upload;
# - dispatch_ms (mvs.search.enqueue, one span a round): the ENQUEUE of the
#   round's scan, selection and signals; it returns before the device ends;
# - stats_ms (mvs.search.wait, one span a round): the round's signal copy,
#   which holds the wait for the scan to end;
# - host_ms (mvs.search.frontier, one span a round): the frontier
#   bookkeeping;
# - collect_ms (mvs.search.collect): the final-level hit filter, copy and
#   exact host recombine;
# and rounds, the count of shared scans. search_index's other stages are
# spans only, inside the call's span mvs.search#<n>: mvs.search.db_norms,
# mvs.search.parse_queries, mvs.search.project, mvs.search.index,
# mvs.search.rescore.
LAST_ADAPTIVE_STAGES: dict = {}


def _level_stats(D: torch.Tensor, min_ip: torch.Tensor,
                 nb_row: torch.Tensor) -> torch.Tensor:
    """Per-query expansion signals of one round: (any score above min_ip
    within the query's OWN nb prefix, the query's nb-th score) as one
    (2, B) float32 tensor."""
    k = D.shape[1]
    in_range = torch.arange(k, device=D.device)[None, :] < nb_row[:, None]
    any_above = ((D > min_ip) & in_range).any(dim=1)
    kth = torch.gather(D, 1, (nb_row - 1).clamp(min=0)[:, None])[:, 0]
    return torch.stack([any_above.to(torch.float32), kth])


def _compact_hits(D, I, qn, nn_all, thr, nb_row, parts=None):
    """Conservative device filter of final-level hits: keep (row, rank)
    where the float32 Jaccard estimate clears thr = j*(1-1e-3) - 1e-6 (the
    host refilters exactly; the slack only prevents false negatives), ranks
    below the row's own nb. -> (rows, db indices, ips, partials or None)
    on the host, in (row, rank) order."""
    k = D.shape[1]
    nn = nn_all[I.clamp(min=0)]
    qn_b = qn[:, None]
    ipqn = D * qn_b * nn
    jac = ipqn / torch.clamp(nn * nn + qn_b * qn_b - ipqn, min=1e-30)
    in_range = torch.arange(k, device=D.device)[None, :] < nb_row[:, None]
    rows, ranks = torch.nonzero((I >= 0) & in_range & (jac > thr),
                                as_tuple=True)
    return (rows.cpu().numpy(), I[rows, ranks].cpu().numpy(),
            D[rows, ranks].cpu().numpy(),
            None if parts is None else parts[rows, ranks].cpu().numpy())


def project_queries(hash_sets, dimension: int, *, device):
    """Hash sets -> (int32 (n, d) projected vectors, float64 copy scaled by
    1/sqrt(d)) — the reference's query-vector rule (jaccard.py:96-118); the
    unscaled integer form feeds the int8-plane exact engine."""
    from ..io.ingest import project_hash_lines
    q_int = project_hash_lines(list(hash_sets), dimension,
                               device=device).astype(np.int32)
    return q_int, q_int.astype(np.float64) / np.sqrt(dimension)


def adaptive_search(index, queries_f64: np.ndarray, j: float,
                    verbose: bool = True, db_norms=None, queries_int=None):
    """Reference expansion semantics (jaccard.py:120-174) on the index's
    device. -> (hits [(query_idx, db_idx, ip)...] in (query, rank) order,
    query_norms (B,) float32).

    queries_int (the UNSCALED integer queries) with an IntExactIndex routes
    every round through the int8-plane engine; emitted hits then carry
    float64-exact cosines. Its nb-prefixes ride the device's float32
    ranking (certified error ~1e-5 in cosine), as the reference's ride
    FAISS's float32 scores. Otherwise the index's search_device serves the
    rounds with float32 scores."""
    LAST_ADAPTIVE_STAGES.clear()
    LAST_ADAPTIVE_STAGES.update(rounds=0, prep_ms=0.0, dispatch_ms=0.0,
                                stats_ms=0.0, collect_ms=0.0, host_ms=0.0,
                                total_ms=0.0)
    with stage("mvs.search.adaptive", LAST_ADAPTIVE_STAGES, "total_ms"):
        return _adaptive_search(index, queries_f64, j, verbose, db_norms,
                                queries_int)


def _adaptive_search(index, queries_f64, j, verbose, db_norms, queries_int):
    """:func:`adaptive_search`'s rounds, its stages timed into
    LAST_ADAPTIVE_STAGES."""
    with stage("mvs.search.prep", LAST_ADAPTIVE_STAGES, "prep_ms"):
        dev = index.device
        queries = queries_f64.astype(np.float32)
        query_norms = np.linalg.norm(queries, axis=1)
        queries = normalize_l2(queries)
        min_ip = np.float32(2 * j / (1 + j))
        min_ip_dev = torch.tensor(min_ip, device=dev)
        int_dev = queries_int is not None and hasattr(index, "_pool") \
            and index.ntotal > 0
        if int_dev:
            from .int_index import gather_rows, query_planes
            Qi = np.ascontiguousarray(queries_int, dtype=np.int32)
            index.validate_queries(Qi)
            qp_all = query_planes(Qi, index.L, dev)          # ONE upload
            qns_int = np.einsum("ij,ij->i", Qi.astype(np.int64),
                                Qi.astype(np.int64))         # exact |q|^2
            with np.errstate(divide="ignore"):
                invq_all = torch.from_numpy(np.where(
                    qns_int > 0, 1.0 / np.sqrt(qns_int.astype(np.float64)),
                    0.0).astype(np.float32)).to(dev)
        else:
            q_dev = torch.from_numpy(queries).to(dev)
    nn_all = None if db_norms is None else torch.from_numpy(
        np.asarray(db_norms, dtype=np.float32)).to(dev)
    thr = torch.tensor(np.float32(j) * np.float32(1.0 - 1e-3)
                       - np.float32(1e-6), device=dev)

    hits: list[tuple[int, int, float]] = []

    def exact_ips(gq, out_i, parts):
        """Host recombine of kernel X partials (c, P) into float64-exact
        cosines dot / sqrt(|v|^2 |q|^2) — IntExactIndex.search's math."""
        dots = pm.combine_plane_partials(parts.T, index.L)
        denom = np.sqrt(index.ns[np.maximum(out_i, 0)].astype(np.float64)
                        * qns_int[gq].astype(np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(denom > 0, dots / np.maximum(denom, 1e-300),
                            0.0)

    def collect(D, I, qidx, nb_rows, parts=None):
        """Emit the final hits of the rows of qidx (nb_rows: each query's
        own result width within the shared scan)."""
        nb = torch.from_numpy(np.asarray(nb_rows, dtype=np.int64)).to(dev)
        if nn_all is None:
            # no db norms: keep every valid candidate (the exact host
            # refilter follows)
            in_range = torch.arange(I.shape[1], device=dev)[None, :] \
                < nb[:, None]
            rows, ranks = torch.nonzero((I >= 0) & in_range, as_tuple=True)
            out = (rows.cpu().numpy(), I[rows, ranks].cpu().numpy(),
                   D[rows, ranks].cpu().numpy(),
                   None if parts is None
                   else parts[rows, ranks].cpu().numpy())
        else:
            qn = torch.from_numpy(
                query_norms[np.asarray(qidx)].astype(np.float32)).to(dev)
            out = _compact_hits(D, I, qn, nn_all, thr, nb, parts)
        rows, out_i, out_ip, out_p = out
        gq = np.asarray(qidx)[rows]
        ips = exact_ips(gq, out_i, out_p) if out_p is not None \
            else out_ip.astype(float)
        hits.extend(zip(gq.tolist(), out_i.tolist(), ips.tolist()))

    # the frontier loop: one shared scan per round serves every query still
    # expanding, at its own level (a larger-k search returns the same
    # ordered prefix)
    level_of = np.zeros(len(queries), dtype=np.int64)
    frontier = list(range(len(queries))) if index.ntotal else []
    while frontier:
        qidx = np.asarray(frontier)
        levels = level_of[qidx]
        nbs = INITIAL_NB_SEARCHES * np.power(3, levels)
        nb_eff = np.minimum(nbs, index.ntotal).astype(np.int64)
        k = int(nb_eff.max())
        if verbose:
            print(f"Searching {sorted(set(nbs.tolist()))} : ", qidx)
        B = len(qidx)
        parts_round = None
        LAST_ADAPTIVE_STAGES["rounds"] += 1
        with stage("mvs.search.enqueue", LAST_ADAPTIVE_STAGES,
                   "dispatch_ms"):
            sel = torch.from_numpy(qidx).to(dev)
            if int_dev:
                flag = pw.range_flag(dev)
                s_dev, I_dev, parts_round = index._pool(
                    gather_rows(qp_all, sel), B, k, flag)
                D_dev = s_dev * invq_all[sel][:, None]
            else:
                D_dev, I_dev = index.search_device(q_dev[sel], k)
            sig = _level_stats(D_dev, min_ip_dev,
                               torch.from_numpy(nb_eff).to(dev))
        with stage("mvs.search.wait", LAST_ADAPTIVE_STAGES, "stats_ms"):
            sig_h = sig.cpu().numpy()    # the round's one mandatory copy
            if int_dev:
                pw.check_range_flag(flag)
            any_above = sig_h[0] > 0
            kth = sig_h[1]
        with stage("mvs.search.frontier", LAST_ADAPTIVE_STAGES, "host_ms"):
            stopped_rows = []
            frontier = []
            for row, q in enumerate(qidx):
                level = int(levels[row])
                deeper = bool(any_above[row]) and kth[row] > min_ip \
                    and nbs[row] < index.ntotal  # a full-db result stops
                if deeper:
                    # estimate how much deeper to go (jaccard.py:162-167)
                    if kth[row] - 0.05 > min_ip and level <= MAX_LEVELS - 3:
                        level_of[q] = level + 2
                        frontier.append(int(q))
                    elif level <= MAX_LEVELS - 2:
                        level_of[q] = level + 1
                        frontier.append(int(q))
                    else:
                        stopped_rows.append(row)
                else:
                    stopped_rows.append(row)
        if stopped_rows:
            with stage("mvs.search.collect", LAST_ADAPTIVE_STAGES,
                       "collect_ms"):
                rows = np.asarray(stopped_rows)
                rsel = torch.from_numpy(rows).to(dev)
                collect(D_dev[rsel], I_dev[rsel], qidx[rows], nb_eff[rows],
                        None if parts_round is None else parts_round[rsel])
    return hits, query_norms


def rescore(hits, query_norms: np.ndarray, names: list[str],
            norms: np.ndarray, j: float, verbose: bool = True):
    """Exact-form float64 Jaccard rescoring + filter + sort
    (jaccard.py:197-224). hits: [(query_idx, db_idx, ip), ...] in
    (query, rank) order. Returns [(query_idx, neighbor_id, jaccard), ...]."""
    by_query: dict[int, list] = {}
    for q, idx, ip in hits:
        by_query.setdefault(q, []).append((idx, ip))
    out = []
    for i in range(len(query_norms)):
        qn = float(query_norms[i])
        if qn == 0:
            continue
        results = []
        for idx, ip in by_query.get(i, ()):
            nid = names[idx]
            nn = float(norms[idx])
            ip = float(ip)
            jac = ip * qn * nn / (nn ** 2 + qn ** 2 - ip * qn * nn)
            if jac > j:
                results.append((nid, jac, ip, nn, qn))
        results.sort(key=lambda x: x[1], reverse=True)
        if verbose:
            print(f"Query {i}:")
        for rank, (nid, jac, ip, nn, qn_) in enumerate(results):
            if verbose:
                print(f"  Neighbor {rank}: {nid} (jaccard: {jac:.4f}), "
                      f"inner_product: {ip:.4f} {nn} {qn_}")
            out.append((i, nid, jac))
    return out


# one-slot index cache: repeated search_index calls in one process re-use
# the staged index instead of staging it per call; one slot bounds device
# memory (a different key evicts)
_INDEX_CACHE: dict = {}


def clear_index_cache() -> None:
    _INDEX_CACHE.clear()
    textparse.clear_norms()


def _cached_index(key, build):
    if _INDEX_CACHE.get("key") == key:
        return _INDEX_CACHE["value"]
    _INDEX_CACHE.clear()
    value = build()
    _INDEX_CACHE["key"] = key
    _INDEX_CACHE["value"] = value
    return value


def _artifact_stat(path: str):
    st = os.stat(path)
    return (os.path.abspath(path), st.st_mtime_ns, st.st_size)


@entry_span("search")
def search_index(index_folder: str, query_file: str, j: float,
                 verbose: bool = True, recall_target: float = 1.0,
                 engine: str = "f32", mesh_devices: int = 1, *, device):
    """Full search pipeline over a db folder (reference search_index,
    jaccard.py:63-224) on ``device``.

    engine: 'f32' (FAISS-parity FlatIPIndex over the faiss.index artifact)
    | 'int8' (int8-plane exact engine staged from the db folder's integer
    vectors; float64-exact cosines, no faiss.index needed) | 'int8_approx'
    (the same engine in its 'approx' mode, which selects exactly in the
    port).

    mesh_devices (``parallel.mesh.serving_mesh``: 1 one device, 0 every
    local device of ``device``'s type, n the first n) above one device
    serves every adaptive level through the distributed indexes (rows or
    chunks split over the devices, candidate pools merged;
    ann/distributed.py); the results are the single-device ones.

    Each call is the profiler span mvs.search#<n>, holding the stage spans
    named beside LAST_ADAPTIVE_STAGES."""
    dev = resolve_device(device)
    mesh = serving_mesh(mesh_devices, device=dev)
    with stage("mvs.search.db_norms"):
        d = DbFolder(index_folder).dimension
        names, norms = textparse.db_names_and_norms(index_folder)
    with stage("mvs.search.parse_queries"):
        _, hash_sets = textparse.parse_queries(query_file)
    with stage("mvs.search.project"):
        q_int, queries = project_queries(hash_sets, d, device=dev)
    where = mesh.key if mesh is not None else str(dev)
    int8 = engine in ("int8", "int8_approx")
    with stage("mvs.search.index"):
        if int8:
            from .int_index import IntExactIndex
            rt = recall_target if recall_target < 1.0 else 0.95
            approx = engine == "int8_approx" or recall_target < 1.0
            mode = "approx" if approx else "exact"
            key = (_artifact_stat(os.path.join(index_folder, "vectors.bin")),
                   "int8", mode, rt, where)
            if mesh is not None:
                # staged straight into the split layout: splitting a
                # single-device index would hold the whole stack on one card
                from .distributed import DistributedIntExactIndex
                index = _cached_index(key, lambda: (
                    DistributedIntExactIndex.from_dbfolder(
                        index_folder, mesh=mesh, mode=mode,
                        recall_target=rt)))
            else:
                index = _cached_index(key, lambda: (
                    IntExactIndex.from_dbfolder(index_folder, mode=mode,
                                                recall_target=rt,
                                                device=dev)))
        else:
            fpath = os.path.join(index_folder, "faiss.index")
            key = (_artifact_stat(fpath), "f32", where)
            if mesh is not None:
                from .distributed import DistributedFlatIPIndex
                index = _cached_index(key, lambda: (
                    DistributedFlatIPIndex.from_flat(
                        FlatIPIndex.load(fpath, device=dev), mesh=mesh)))
            else:
                index = _cached_index(key, lambda: FlatIPIndex.load(
                    fpath, device=dev))
            index.recall_target = recall_target
    hits, query_norms = adaptive_search(index, queries, j, verbose,
                                        db_norms=norms,
                                        queries_int=q_int if int8 else None)
    with stage("mvs.search.rescore"):
        return rescore(hits, query_norms, names, norms, j, verbose)
