"""Driver ``study_job``: ``shard_job``'s job of ``num_shards`` shards of the
all-vs-all matrix (``matrix.compute.compute_pairwise_shard``), shard after
shard, over and over, on a db of related runs: hash sets that share hashes
by Zipf popularity (``gen_hashes.make_sets``, the configuration's
``sharing``), projected by the plain reference (``reference.exact.project``)
and written in the upstream folder format.

Traffic keys are ``shard_job``'s; its calls, its check and the warm cache
are its own. Set-up makes the sets, projects them, writes the db and runs
the job's last shard once: it stages the db (the residency slot, when the
traffic is warm) and runs every stage at the window's sizes. The check
reports the bytes the run wrote.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from portbench import gen, gen_hashes, spec
from portbench.reference import exact

_Job = spec.driver("shard_job",
                   os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bytes_under(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


class Driver(_Job):
    """``compute_pairwise_shard`` over the shards of one job, on a db
    projected from related hash sets."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, work: str,
                 device: str):
        from metagenome_vector_sketches_tpu_torch.matrix import compute
        self.compute = compute
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.work = work
        self.db = os.path.join(work, "db")
        self.out = os.path.join(work, "shards")
        self.n, self.d = int(cfg["num_vectors"]), int(cfg["dimension"])
        sets = gen_hashes.make_sets(dict(cfg, num_sets=self.n), seed, device)
        hashes = sets["hashes"].cpu().numpy().view(np.uint64)
        offsets = sets["offsets"].cpu().numpy()
        del sets
        V = exact.project(hashes, offsets, self.d, device)
        del hashes
        info = gen.write_db(self.db, V, cfg["dtype"])
        del V
        gen.free_device()
        self.S = int(traffic["num_shards"])
        self.meta = {"n": self.n, "d": self.d, "dtype": cfg["dtype"],
                     "max_abs": info["max_abs"],
                     "P": exact.planes(info["max_abs"]),
                     "hashes": int(offsets[-1])}
        print(f"study db: {self.n} runs, {self.meta['hashes']} hashes, "
              f"largest component {info['max_abs']}", file=sys.stderr)
        self.cold = traffic["cache"] == "cold"
        compute.clear_device_cache()
        self._shard(self.S - 1, os.path.join(work, "warmup"), self.S)
        if self.cold:
            compute.clear_device_cache()

    def check(self, calls: list, precision: str = "exact") -> dict:
        out = super().check(calls, precision)
        print(f"the run wrote {_bytes_under(self.work)} bytes (the db "
              f"{_bytes_under(self.db)}, {len(calls)} shard folders)",
              file=sys.stderr)
        return out
