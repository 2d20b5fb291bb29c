"""Driver ``search``: an open loop of requests due at a fixed rate
(``rate_per_s``), served one at a time as a single server process serves
them; each request is one ``ann.search.search_index`` over one query file,
the files in turn.

Traffic keys: ``files``, ``queries_per_file`` and ``relatives`` (the query
pool, ``gen.query_pool``); ``j``, the search's Jaccard threshold;
``rate_per_s``; ``jaccard_gap_limit``; ``program_args``, passed unchanged
to ``search_index`` (``engine``, ``recall_target``, ...). The ``f32``
engine (the entry's default) reads the db folder's ``faiss.index``, which a
deployment builds with ``jaccard index``: set-up then builds it the same
way, with ``ann.flat_index.index_vectors``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from portbench import gen
from portbench.reference import exact
from portbench.reference import search as search_ref
from portbench.trace import span


class Driver:
    """``search_index`` over the query files, one request at a time."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, work: str,
                 device: str):
        from metagenome_vector_sketches_tpu_torch.ann import search
        self.search = search
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.db = os.path.join(work, "db")
        V, lay = gen.make_vectors(cfg, seed, device)
        self.pool = gen.query_pool(cfg, traffic, seed)
        sets, _ = gen.relatives(self.pool, seed)
        free = np.flatnonzero(lay["group_of"] < 0)
        rng = np.random.default_rng([seed, 5])
        rows = np.sort(rng.choice(free, size=len(sets), replace=False))
        if len(sets):
            flat, off = gen.csr(sets)
            V[torch.from_numpy(rows).to(V.device)] = \
                exact.project(flat, off, int(cfg["dimension"]), V.device)
            gen.pin_max(V, lay, cfg)
        info = gen.write_db(self.db, V, cfg["dtype"])
        del V
        gen.free_device()
        if traffic["program_args"].get("engine", "f32") == "f32":
            from metagenome_vector_sketches_tpu_torch.ann import flat_index
            flat_index.index_vectors(self.db, verbose=False)
        self.files = gen.write_query_files(os.path.join(work, "queries"),
                                           self.pool)
        self.n, self.d = int(cfg["num_vectors"]), int(cfg["dimension"])
        self.meta = {"n": self.n, "d": self.d, "dtype": cfg["dtype"],
                     "max_abs": info["max_abs"],
                     "P": exact.planes(info["max_abs"])}
        search.clear_index_cache()
        self._request(0)

    def _request(self, f: int):
        return self.search.search_index(
            self.db, self.files[f], float(self.tr["j"]), verbose=False,
            device=self.device, **self.tr["program_args"])

    def due(self, i: int, t0: float) -> float:
        """Request i is due i / rate_per_s seconds into the window."""
        return t0 + i / float(self.tr["rate_per_s"])

    def call(self, i: int, due: float) -> dict:
        """One request, sent at its due time or, when the requests before
        it have run late, as soon as they return; its latency counts from
        the due time."""
        f = i % len(self.files)
        wait = due - time.perf_counter()
        if wait > 0:
            with span("portbench.until_due"):
                time.sleep(wait)
        t0 = time.perf_counter()
        with span(f"portbench.search_{f}"):
            hits = self._request(f)
        t1 = time.perf_counter()
        return {"kind": "search", "f": f, "t0": t0, "t1": t1,
                "span_ms": (t1 - t0) * 1e3, "late_ms": (t0 - due) * 1e3,
                "latency_ms": (t1 - due) * 1e3,
                "stages": dict(self.search.LAST_ADAPTIVE_STAGES),
                "queries": len(gen.file_queries(self.pool, f)),
                "n": self.n, "hits": hits}

    def free(self):
        self.search.clear_index_cache()
        gen.free_device()

    def check(self, calls: list, precision: str = "exact") -> dict:
        """Numbers compared, each (value, limit): hits that the request
        returned and the reference does not, or the other way round (a
        query, a db row); the widest relative gap of a common hit's Jaccard;
        requests of one file whose hits differ from its first request's."""
        ref = gen.read_db(self.db, self.device)
        j = float(self.tr["j"])
        first: dict = {}
        for c in calls:
            first.setdefault(c["f"], c)
        differ = repeats = compared = 0
        gap = 0.0
        for f, c in sorted(first.items()):
            ids = gen.file_queries(self.pool, f)
            flat, off = gen.csr([self.pool["hashes"][q] for q in ids])
            q_int = exact.project(flat, off, ref["d"], ref["V"].device)
            want = search_ref.search(ref, q_int.cpu().numpy(), j, precision)
            got: list = [dict() for _ in ids]
            for qi, name, jac in c["hits"]:
                got[qi][name] = jac
            for g, w in zip(got, want):
                compared += len(w)
                differ += len(set(g) ^ set(w))
                for name in set(g) & set(w):
                    gap = max(gap, abs(g[name] - w[name]) / abs(w[name]))
            repeats += sum(o["hits"] != c["hits"] for o in calls
                           if o["f"] == f and o is not c)
        del ref
        gen.free_device()
        print(f"compared {compared} reference hits of {len(first)} request "
              f"files ({precision})", file=sys.stderr)
        return {"hits_differing": (differ, 0),
                "jaccard_gap": (gap, float(self.tr["jaccard_gap_limit"])),
                "repeats_differing": (repeats, 0)}
