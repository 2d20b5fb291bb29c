"""The plain reference of the exact MinHash shard (the upstream's
``pairwise_comp --strategy 1``): each requested row's intersection with
every set, from the sets' sorted hash arrays alone, then the upstream
retention test and the writer's quantisation. Plain PyTorch and numpy; it
imports nothing of the program.

Intersections: every hash of a block of rows is looked up in the sorted
array of all (hash, set) pairs (``torch.searchsorted``: the range of sets
that hold it), the ranges are expanded and counted by (row, set) with
``torch.bincount``. No class of hashes is set apart and no product of
incidence matrices is formed.

Retention of a pair (i, j): inter > 0.05 * (|i| + |j|) in float64, the
self-pair included (ops/minhash.py::minhash_triples of the JAX package).
Value: J = inter / (|i| + |j| - inter), stored as floor(255 J + 0.5).

``precision`` selects the arithmetic: "exact" (int64 counts, the float64
test), or the controls: "float32" (the test and J in float32) and "int16"
(every count saturated to the int16 range first).
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("exact", "float32", "int16")
# (hash, set) lookups expanded at once
EXPAND_BUDGET = 1 << 26


class Sets:
    """The sets as sorted hash arrays: ``hashes`` (H,) int64, each set's
    ascending, ``offsets`` (N+1,) int64, on one device; and every (hash,
    set) pair sorted by hash."""

    def __init__(self, hashes: torch.Tensor, offsets: torch.Tensor):
        self.hashes, self.offsets = hashes, offsets
        self.n = len(offsets) - 1
        self.sizes = (offsets[1:] - offsets[:-1]).cpu().numpy()
        set_of = torch.repeat_interleave(
            torch.arange(self.n, device=hashes.device),
            offsets[1:] - offsets[:-1])
        self.sorted, order = torch.sort(hashes, stable=True)
        self.set_of = set_of[order]


def intersections(sets: Sets, rows: np.ndarray) -> torch.Tensor:
    """(len(rows), N) int64 counts |row & set|, on the sets' device."""
    dev = sets.hashes.device
    rows = np.asarray(rows, dtype=np.int64)
    off = sets.offsets.cpu().numpy()
    out = torch.zeros((len(rows), sets.n), dtype=torch.int64, device=dev)
    k = 0
    while k < len(rows):
        # a block of rows whose lookups fit the budget (at least one row)
        q, qrow, total, e = [], [], 0, k
        while e < len(rows):
            r = int(rows[e])
            h = sets.hashes[off[r]:off[r + 1]]
            lo = torch.searchsorted(sets.sorted, h)
            hi = torch.searchsorted(sets.sorted, h, right=True)
            cnt = int((hi - lo).sum())
            if e > k and total + cnt > EXPAND_BUDGET:
                break
            q.append((lo, hi - lo))
            qrow.append(torch.full((len(h),), e - k, dtype=torch.int64,
                                   device=dev))
            total += cnt
            e += 1
        lo = torch.cat([a for a, _ in q])
        cnt = torch.cat([b for _, b in q])
        qr = torch.cat(qrow)
        start = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        idx = torch.repeat_interleave(lo, cnt) + (
            torch.arange(int(cnt.sum()), device=dev) - start)
        key = torch.repeat_interleave(qr, cnt) * sets.n + sets.set_of[idx]
        out[k:e] = torch.bincount(key, minlength=(e - k) * sets.n) \
            .view(e - k, sets.n)
        k = e
    return out


def shard_rows(sets: Sets, rows: np.ndarray, precision: str = "exact"):
    """Expected record of each of ``rows``: a list of (columns int64,
    quantised Jaccards int64)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    inter = intersections(sets, rows)
    if precision == "int16":
        inter = inter.clamp(max=32767)
    dev = inter.device
    ft = torch.float32 if precision == "float32" else torch.float64
    sz = torch.from_numpy(sets.sizes).to(dev)
    out = []
    for i, r in enumerate(np.asarray(rows, dtype=np.int64)):
        tot = (sz[r] + sz).to(ft)
        x = inter[i].to(ft)
        keep = x > torch.tensor(0.05, dtype=ft, device=dev) * tot
        cols = torch.nonzero(keep).flatten()
        xi = x[cols]
        jac = xi / (tot[cols] - xi)
        jac = torch.clamp(torch.nan_to_num(jac, nan=0.0), 0.0, 1.0)
        q = torch.floor(jac * torch.tensor(255.0, dtype=ft, device=dev)
                        + torch.tensor(0.5, dtype=ft, device=dev))
        out.append((cols.cpu().numpy().astype(np.int64),
                    q.cpu().numpy().astype(np.int64)))
    return out
