"""Driver ``shard_job``: a job of ``num_shards`` shards of the all-vs-all
matrix, shard after shard, over and over
(``matrix.compute.compute_pairwise_shard``).

Traffic keys: ``num_shards``; ``cache``: ``"cold"`` empties the program's
residency cache before every shard, so that each one stages the db as a
task of a job array does, ``"warm"`` stages once in set-up and lets every
shard reuse the planes; ``check_rows_per_shard``, the rows of each shard
compared with the reference; ``program_args``, passed unchanged to
``compute_pairwise_shard`` (``tile_rows``, ``engine``,
``device_budget_bytes``, ``finalize``, ``gate``, ...).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch

from portbench import gen
from portbench.reference import exact, shardfmt
from portbench.trace import span

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
# the warm-up runs the last shard of a job of this many shards: every stage
# at the window's tile shapes over a sliver of rows, and the db staged
WARMUP_SHARDS = 256


def _digest(folder: str) -> str:
    h = hashlib.sha256()
    for f in SHARD_FILES:
        with open(os.path.join(folder, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


class Driver:
    """``compute_pairwise_shard`` over the shards of one job."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, work: str,
                 device: str):
        from metagenome_vector_sketches_tpu_torch.matrix import compute
        self.compute = compute
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.db = os.path.join(work, "db")
        self.out = os.path.join(work, "shards")
        V, _ = gen.make_vectors(cfg, seed, device)
        info = gen.write_db(self.db, V, cfg["dtype"])
        del V
        gen.free_device()
        self.n, self.d = int(cfg["num_vectors"]), int(cfg["dimension"])
        self.S = int(traffic["num_shards"])
        self.meta = {"n": self.n, "d": self.d, "dtype": cfg["dtype"],
                     "max_abs": info["max_abs"],
                     "P": exact.planes(info["max_abs"])}
        self.cold = traffic["cache"] == "cold"
        compute.clear_device_cache()
        self._shard(WARMUP_SHARDS - 1, os.path.join(work, "warmup"),
                    WARMUP_SHARDS)
        if self.cold:
            compute.clear_device_cache()

    def _shard(self, k: int, out: str, shards: int) -> str:
        return self.compute.compute_pairwise_shard(
            self.db, out, num_shards=shards, shard_idx=k, verbose=False,
            device=self.device, **self.tr["program_args"])

    def rows_of(self, k: int) -> tuple[int, int]:
        per = (self.n + self.S - 1) // self.S
        return k * per, min((k + 1) * per, self.n)

    def due(self, i: int, t0: float) -> None:
        """A job's shards run back to back: no schedule."""
        return None

    def call(self, i: int, due=None) -> dict:
        k = i % self.S
        if self.cold:
            self.compute.clear_device_cache()
        out = os.path.join(self.out, f"call_{i:04d}")
        t0 = time.perf_counter()
        with span(f"portbench.shard_{k}"):
            folder = self._shard(k, out, self.S)
        t1 = time.perf_counter()
        stages = {a: b for a, b in self.compute.LAST_STAGES.items()
                  if not isinstance(b, list)}
        b, e = self.rows_of(k)
        return {"kind": "shard", "k": k, "t0": t0, "t1": t1,
                "span_ms": (t1 - t0) * 1e3, "stages": stages,
                "rows": e - b, "n": self.n, "folder": folder}

    def free(self):
        self.compute.clear_device_cache()
        gen.free_device()

    def check(self, calls: list, precision: str = "exact") -> dict:
        """Numbers compared, each (value, limit): rows of a shard range
        that the written folder lacks; sampled rows whose written record
        (columns, quantised Jaccards) differs from the reference's; written
        copies of a shard that differ in a byte from the first copy."""
        ref = gen.read_db(self.db, self.device)
        V, ns, d = ref["V"], ref["ns"], ref["d"]
        rng = np.random.default_rng([self.seed, 4])
        per_shard = int(self.tr["check_rows_per_shard"])
        first: dict = {}
        for c in calls:
            first.setdefault(c["k"], c)
        missing = differing = copies = pairs = 0
        sq = V.to(torch.int64).square().sum(1).cpu().numpy()
        for k, c in sorted(first.items()):
            b, e = self.rows_of(k)
            shard = shardfmt.Shard(c["folder"])
            # every row whose self-pair the reference retains has a record
            self_keep = exact.retained(torch.from_numpy(sq[b:e]),
                                       torch.from_numpy(0.1 * ns[b:e]), d,
                                       ref["dtype"]).numpy()
            want = np.arange(b, e)[self_keep]
            missing += len(np.setdiff1d(want, shard.rows))
            missing += int(((shard.rows < b) | (shard.rows >= e)).sum())
            rows = np.sort(rng.choice(np.arange(b, e),
                                      size=min(per_shard, e - b),
                                      replace=False))
            expect = exact.shard_rows(V, rows, ns, d, ref["dtype"],
                                      precision)
            for r, (cols, q) in zip(rows, expect):
                pairs += len(cols)
                got_c, got_q = shard.row(r)
                if not (np.array_equal(got_c, cols)
                        and np.array_equal(got_q, q)):
                    differing += 1
            base = _digest(c["folder"])
            copies += sum(_digest(o["folder"]) != base for o in calls
                          if o["k"] == k and o is not c)
        del V, ref
        gen.free_device()
        print(f"compared {pairs} reference pairs of {len(first)} shards' "
              f"sampled rows ({precision})", file=sys.stderr)
        return {"rows_missing": (missing, 0), "rows_differing": (differing, 0),
                "copies_differing": (copies, 0)}
