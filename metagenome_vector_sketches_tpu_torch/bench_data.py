"""Synthetic inputs and a row oracle for the port's GPU smoke test
(``chip_smoke.py``), kept in the port so that the test imports nothing of
the JAX package or of ``benchmarks/``.

``synth_hashes_file`` writes the same file as the JAX package's
whole-pipeline benchmark (``benchmarks/full_pipeline.py``) from the same
seed; ``spot_check`` is its sampled-row parity check
(``benchmarks/stream_scale.py``) on the port's own reader and writer.
"""

from __future__ import annotations

import os

import numpy as np

from .io.dbfolder import DbFolder
from .matrix.reader import MatrixReader
from .matrix.writer import quantize_jaccard

GROUP = 4
BASE_HASHES = 256
SHARED = 160
HEAVY_HASHES = 2048


def synth_hashes_file(path, N, n_groups, n_heavy, seed=7):
    """Plant n_groups groups of GROUP rows sharing SHARED hashes; write the
    all_hashes.txt exactly in the library's on-disk format (io/hashes.py).
    The last n_heavy rows carry HEAVY_HASHES hashes, so max_component
    exceeds 127 and the engine runs the 2-limb (P = 3) planes."""
    rng = np.random.default_rng(seed)
    grouped = n_groups * GROUP
    if grouped + n_heavy > N:
        raise ValueError(f"{n_groups} groups of {GROUP} and {n_heavy} heavy "
                         f"rows do not fit in N = {N}")
    with open(path, "w") as f:
        for g in range(n_groups):
            shared = rng.integers(0, 2**63, size=SHARED, dtype=np.uint64)
            for m in range(GROUP):
                priv = rng.integers(0, 2**63, size=BASE_HASHES - SHARED,
                                    dtype=np.uint64)
                row = np.sort(np.concatenate([shared, priv]))
                f.write(f"ACC{g * GROUP + m:07d}: "
                        + " ".join(map(str, row.tolist())) + "\n")
        for i in range(grouped, N):
            n_h = HEAVY_HASHES if i >= N - n_heavy else BASE_HASHES
            row = np.sort(rng.integers(0, 2**63, size=n_h, dtype=np.uint64))
            f.write(f"ACC{i:07d}: " + " ".join(map(str, row.tolist())) + "\n")


TOY_HASHES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "ref_toy",
    "all_hashes_toy.txt")


def skewed_set_sizes(path=TOY_HASHES, seed=5) -> np.ndarray:
    """Real FracMinHash set sizes: the sizes of the sets of an
    all_hashes.txt file (default: the reference toy fixture's 61 accessions,
    3 to 80,772 hashes, median 156), drawn with replacement from a seed
    until one more would overflow the batch that ``project_many`` sends to
    kernel P (BATCH_SETS sets, BATCH_HASHES hashes)."""
    from .ops.projection import BATCH_HASHES, BATCH_SETS
    with open(path) as f:
        base = np.array([len(ln.split(":", 1)[1].split()) for ln in f
                         if ":" in ln], dtype=np.int64)
    draw = np.random.default_rng(seed).choice(base, size=BATCH_SETS)
    n = int(np.searchsorted(np.cumsum(draw), BATCH_HASHES, side="right"))
    return draw[:max(1, n)]


def csr_hashes(sizes, seed=1):
    """Random uint64 hashes (full range) for sets of the given sizes, all
    sets' in one run -> their int64 bit patterns, numpy."""
    flat = np.random.default_rng(seed).integers(
        0, 2**64, size=int(np.sum(sizes)), dtype=np.uint64)
    return flat.view(np.int64)


def spot_check(db_path, matrix_path, N, d, n_rows=3, seed=1) -> bool:
    """Sampled-row parity of a one-shard matrix folder against the exact
    float64/int64 oracle computed from the on-disk vectors."""
    db = DbFolder(db_path)
    _, norms = db.names_and_norms()
    ns = norms * norms
    Vmm = np.memmap(os.path.join(db_path, "vectors.bin"), dtype=np.int32,
                    mode="r", shape=(N, d))
    reader = MatrixReader(matrix_path)
    rng = np.random.default_rng(seed)
    rows = sorted(int(r) for r in
                  rng.choice(np.arange(N), size=n_rows, replace=False))
    decoded = reader.load_neighbors_for_rows(rows, N)
    ok = True
    for row, dec in zip(rows, decoded):
        v = Vmm[row].astype(np.int64)
        dots = np.empty(N, dtype=np.int64)
        B = 131072
        for s in range(0, N, B):
            dots[s:s + B] = Vmm[s:s + B].astype(np.int64) @ v
        q = np.where(dots >= 0, dots // d, -((-dots) // d))
        keep = q.astype(np.float64) > 0.05 * (ns[row] + ns)
        cols = np.flatnonzero(keep)
        want_q = quantize_jaccard(dots[cols], np.full(len(cols), row),
                                  cols, ns, d)
        if dec is None:
            ok = ok and len(cols) == 0
            continue
        got_cols, got_q = dec
        ok = ok and np.array_equal(np.asarray(got_cols), cols) \
            and np.array_equal(np.asarray(got_q, dtype=np.uint16), want_q)
    return ok
