"""Driver ``minhash_job``: a job of ``num_shards`` exact MinHash shards of
one collection (``pairwise_comp --strategy 1``,
``matrix.compute.compute_minhash_shard``), shard after shard, over and
over.

The collection is made from the seed (``gen_hashes``) and written as the
upstream's ``all_hashes.txt``. Traffic keys: ``num_shards``; ``cache``:
``"warm"`` stages the sets once in set-up (the program's staged-sets slot)
and lets every shard reuse them, ``"cold"`` empties the slot before every
shard; ``check_rows_per_shard``, the rows of each shard compared with the
reference; ``program_args``, passed unchanged to
``compute_minhash_shard``.

A program without the staged-sets slot (``stage_minhash_sets``) computes
every shard's N x N matrix from a parse of its own: set-up fails at once
there, before any input is made.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

from portbench import gen, gen_hashes
from portbench.reference import minhash as ref
from portbench.reference import shardfmt
from portbench.trace import span

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")


def _digest(folder: str) -> str:
    h = hashlib.sha256()
    for f in SHARD_FILES:
        with open(os.path.join(folder, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


class Driver:
    """``compute_minhash_shard`` over the shards of one job."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, work: str,
                 device: str):
        from metagenome_vector_sketches_tpu_torch.matrix import compute
        if not hasattr(compute, "stage_minhash_sets"):
            raise RuntimeError("the program has no staged-sets slot "
                               "(matrix.compute.stage_minhash_sets): its "
                               "MinHash shards recompute N x N each")
        self.compute = compute
        self.tr, self.seed, self.device = traffic, seed, device
        os.makedirs(work, exist_ok=True)
        self.path = os.path.join(work, "all_hashes.txt")
        self.out = os.path.join(work, "shards")
        sets = gen_hashes.make_sets(cfg, seed, device)
        text = gen_hashes.write_hashes_text(self.path, sets)
        # the reference's copy, on the host until the check
        self.hashes = sets["hashes"].cpu()
        self.offsets = sets["offsets"].cpu()
        del sets
        gen.free_device()
        self.n = int(cfg["num_sets"])
        self.S = int(traffic["num_shards"])
        self.meta = {"n": self.n, "hashes": int(self.offsets[-1]),
                     "text_bytes": text}
        self.cold = traffic["cache"] == "cold"
        compute.clear_device_cache()
        # warm-up: the last shard stages the sets and runs every stage at
        # the window's shapes
        self._shard(self.S - 1, os.path.join(work, "warmup"))
        if self.cold:
            compute.clear_device_cache()

    def _shard(self, k: int, out: str) -> str:
        return self.compute.compute_minhash_shard(
            self.path, out, num_shards=self.S, shard_idx=k, verbose=False,
            device=self.device, **self.tr["program_args"])

    def rows_of(self, k: int) -> tuple[int, int]:
        per = (self.n + self.S - 1) // self.S
        return min(k * per, self.n), min((k + 1) * per, self.n)

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
            folder = self._shard(k, out)
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
        """Numbers compared, each (value, limit): nonempty rows of a shard
        range that the written folder lacks (every such row keeps its
        self-pair), and rows it holds outside the range; sampled rows whose
        written record (columns, quantised Jaccards) differs from the
        reference's; written copies of a shard that differ in a byte from
        the first copy."""
        sets = ref.Sets(self.hashes.to(self.device),
                        self.offsets.to(self.device))
        rng = np.random.default_rng([self.seed, 4])
        per_shard = int(self.tr["check_rows_per_shard"])
        first: dict = {}
        for c in calls:
            first.setdefault(c["k"], c)
        missing = differing = copies = pairs = 0
        for k, c in sorted(first.items()):
            b, e = self.rows_of(k)
            shard = shardfmt.Shard(c["folder"])
            want = np.arange(b, e)[sets.sizes[b:e] > 0]
            missing += len(np.setdiff1d(want, shard.rows))
            missing += int(((shard.rows < b) | (shard.rows >= e)).sum())
            rows = np.sort(rng.choice(np.arange(b, e),
                                      size=min(per_shard, e - b),
                                      replace=False))
            for r, (cols, q) in zip(rows, ref.shard_rows(sets, rows,
                                                         precision)):
                pairs += len(cols)
                got_c, got_q = shard.row(r)
                if not (np.array_equal(got_c, cols)
                        and np.array_equal(got_q, q)):
                    differing += 1
            base = _digest(c["folder"])
            copies += sum(_digest(o["folder"]) != base for o in calls
                          if o["k"] == k and o is not c)
        del sets
        gen.free_device()
        print(f"compared {pairs} reference pairs of {len(first)} shards' "
              f"sampled rows ({precision})", file=sys.stderr)
        return {"rows_missing": (missing, 0), "rows_differing": (differing, 0),
                "copies_differing": (copies, 0)}
