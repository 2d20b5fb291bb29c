"""The db-folder artifact contract.

Layout (reference src/project_everything.cpp:306-361):
  vectors.bin       N consecutive d-dim little-endian int32 (or int16) vectors
  vector_norms.txt  "<accession> <norm>" per line; norm = ||v/sqrt(d)||_2
                    computed in float32 and printed with 6 significant digits
                    (C++ default ostream precision); doubles as the id->index
                    map and the N counter for every consumer
  dimension.txt     single int
  dtype.txt         "int32" | "int16"

Byte-for-byte compatible with the reference on the toy dataset
(tests/test_dbfolder.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _format_norm(x: float) -> str:
    """C++ `ostream << double` default formatting (6 significant digits)."""
    return f"{x:.6g}"


def _eigen_f32_sum(p: np.ndarray) -> np.ndarray:
    """Sum float32 rows of shape (N, size) in the exact order of Eigen 3.2's
    LinearVectorizedTraversal redux with SSE2 packets (Redux.h:110-160,
    arch/SSE/PacketMath.h predux<Packet4f>): two 4-lane accumulators over
    stride-8, lane combine (a0+a2)+(a1+a3), then a scalar tail.

    Vectorized over N (the loop is over size/8 chunks only), so it stays fast
    for large databases.
    """
    p = p.astype(np.float32, copy=False)
    N, size = p.shape
    if size < 4:
        res = p[:, 0].copy()
        for k in range(1, size):
            res = res + p[:, k]
        return res
    n4 = (size // 4) * 4
    n8 = (size // 8) * 8
    if size >= 8:
        chunks = p[:, :n8].reshape(N, -1, 2, 4)
        acc0 = chunks[:, 0, 0, :].copy()
        acc1 = chunks[:, 0, 1, :].copy()
        for k in range(1, chunks.shape[1]):
            acc0 = acc0 + chunks[:, k, 0, :]
            acc1 = acc1 + chunks[:, k, 1, :]
        acc = acc0 + acc1
        if n4 > n8:
            acc = acc + p[:, n8:n8 + 4]
    else:
        acc = p[:, :4].copy()
    res = (acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])
    for k in range(n4, size):
        res = res + p[:, k]
    return res


def compute_norms(vectors: np.ndarray, dimension: int) -> np.ndarray:
    """Reference norm pipeline: cast int32 -> float32, divide by float32
    sqrt(d), take the float32 L2 norm (src/project_everything.cpp:327-329),
    reproducing Eigen's packet reduction order bit-for-bit so the printed
    6-significant-digit text matches exactly. Chunked over rows (the
    reduction is per-row, so chunking is bit-invariant) — full-array f32
    temporaries doubled a 2 GB db's footprint during write (r5)."""
    sq = np.sqrt(np.float32(dimension)).astype(np.float32)
    n = len(vectors)
    out = np.empty(n, dtype=np.float64)
    step = max(1, (64 << 20) // max(1, vectors.shape[1] * 4))
    for s in range(0, n, step):
        vf = vectors[s:s + step].astype(np.float32) / sq
        sumsq = _eigen_f32_sum(vf * vf)
        out[s:s + step] = np.sqrt(sumsq).astype(np.float32)
    return out


def cap_int16(vectors: np.ndarray) -> np.ndarray:
    """--int16 overflow capping (src/project_everything.cpp:332-347)."""
    return np.clip(vectors, -32768, 32767).astype(np.int16)


@dataclass
class DbFolder:
    path: str

    # -- writing ------------------------------------------------------------
    @staticmethod
    def write(path: str, names, vectors: np.ndarray, dimension: int,
              use_int16: bool = False, wipe: bool = True) -> "DbFolder":
        os.makedirs(path, exist_ok=True)
        if wipe:
            import shutil
            for entry in os.listdir(path):
                full = os.path.join(path, entry)
                if os.path.isdir(full):
                    # the reference wipes subdirectories too (fs::remove_all
                    # per entry, project_everything.cpp:244-249) — stale
                    # shard_K/ folders must not survive a rebuild
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    os.remove(full)
        names = list(names)
        if len(names) != len(vectors):
            raise ValueError(
                f"{len(names)} names for {len(vectors)} vectors — refusing "
                "to write a misaligned db folder (vector_norms.txt line "
                "order is the authoritative row index)")
        bad = [i for i, n in enumerate(names)
               if not str(n).strip() or any(c.isspace() for c in str(n))]
        if bad:
            raise ValueError(
                f"empty or whitespace-containing accession names at rows "
                f"{bad[:5]}{'...' if len(bad) > 5 else ''}: such a "
                "vector_norms.txt line cannot round-trip (readers split on "
                "whitespace), silently misaligning every later row")
        norms = compute_norms(vectors, dimension)
        with open(os.path.join(path, "dimension.txt"), "w") as f:
            f.write(f"{dimension}\n")
        with open(os.path.join(path, "dtype.txt"), "w") as f:
            f.write(("int16" if use_int16 else "int32") + "\n")
        with open(os.path.join(path, "vector_norms.txt"), "w") as f:
            for name, norm in zip(names, norms):
                f.write(f"{name} {_format_norm(float(norm))}\n")
        data = cap_int16(vectors) if use_int16 else \
            vectors.astype(np.int32, copy=False)
        data.tofile(os.path.join(path, "vectors.bin"))
        # extension to the reference's file-config pattern: the global max
        # |component|, persisted so the pairwise engine's limb-count pick
        # needs no extra vectors.bin pass per shard job. Two reductions,
        # no temporaries: abs(int64(data)) materialized 8.6 GB of copies
        # at N=262k and dominated the db-write wall (r5)
        max_abs = max(int(data.max(initial=0)),
                      -int(data.min(initial=0))) if data.size else 0
        with open(os.path.join(path, "max_component.txt"), "w") as f:
            f.write(f"{max_abs}\n")
        return DbFolder(path)

    # -- reading ------------------------------------------------------------
    @property
    def dimension(self) -> int:
        with open(os.path.join(self.path, "dimension.txt")) as f:
            return int(f.read().strip())

    @property
    def dtype(self) -> str:
        p = os.path.join(self.path, "dtype.txt")
        if not os.path.exists(p):
            return "int32"
        with open(p) as f:
            return f.read().strip() or "int32"

    def max_component(self) -> int | None:
        """Persisted global max |component| (max_component.txt), or None for
        foreign dbs built by the reference binaries (callers scan instead).
        Ignored if stale (older than vectors.bin)."""
        p = os.path.join(self.path, "max_component.txt")
        vec = os.path.join(self.path, "vectors.bin")
        try:
            if os.path.getmtime(p) < os.path.getmtime(vec):
                return None
            with open(p) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def names_and_norms(self) -> tuple[list[str], np.ndarray]:
        """Parse vector_norms.txt. Norms are returned as float64 exactly as
        parsed from text — consumers square them as the |set| estimate
        (reference parses with stod, pairwise_comp_optimized.cpp:893-901).
        The parse is cached per (mtime, size) of the file: on a 1M-row db
        this is megabytes of text, and engine startup touches num_vectors,
        id_to_index and names_and_norms back-to-back."""
        p = os.path.join(self.path, "vector_norms.txt")
        st = os.stat(p)
        key = (st.st_mtime_ns, st.st_size)
        cached = getattr(self, "_norms_cache", None)
        if cached is not None and cached[0] == key:
            names, norms = cached[1]
            return list(names), norms.copy()
        names, norms = [], []
        with open(p) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                names.append(parts[0])
                norms.append(float(parts[1]))
        norms = np.array(norms, dtype=np.float64)
        self._norms_cache = (key, (tuple(names), norms))
        return names, norms.copy()

    def names_and_norms_f32(self) -> tuple[list[str], np.ndarray]:
        """float32 parse — the query stack parses norms as float
        (read_pc_mat_cmp.cpp:57-76)."""
        names, norms = self.names_and_norms()
        return names, norms.astype(np.float32)

    @property
    def num_vectors(self) -> int:
        names, _ = self.names_and_norms()
        return len(names)

    def id_to_index(self) -> dict[str, int]:
        names, _ = self.names_and_norms()
        return {n: i for i, n in enumerate(names)}

    def load_vectors(self, start: int = 0, end: int | None = None) -> np.ndarray:
        """Load a row range of vectors.bin as (n, d) with the stored dtype."""
        d = self.dimension
        dt = np.int16 if self.dtype == "int16" else np.int32
        itemsize = np.dtype(dt).itemsize
        path = os.path.join(self.path, "vectors.bin")
        total = os.path.getsize(path) // (d * itemsize)
        if end is None:
            end = total
        end = min(end, total)
        n = max(0, end - start)
        arr = np.fromfile(path, dtype=dt, count=n * d, offset=start * d * itemsize)
        return arr.reshape(n, d)

    def total_vectors_from_bin(self) -> int:
        """N derived from the vectors.bin file size, as the pairwise engine
        does (pairwise_comp_optimized.cpp:911-914)."""
        d = self.dimension
        itemsize = 2 if self.dtype == "int16" else 4
        return os.path.getsize(os.path.join(self.path, "vectors.bin")) // (d * itemsize)
