"""Ingest: ``all_hashes.txt`` -> db folder through the port's projection.

``convert`` (signature folder -> hashes file), ``parse_hashes_file`` and
``DbFolder.write`` are the JAX package's host code (no JAX inside); only
the projection runs here, on the caller's device.
"""

from __future__ import annotations

import time

import numpy as np

from ..host import DbFolder, convert, log, parse_hashes_file  # noqa: F401
from ..ops.projection import project_many


def sketch(hash_file: str, index_folder: str, dimension: int = 2048,
           use_int16: bool = False, *, device,
           verbose: bool = True) -> DbFolder:
    """Project every hash set of ``hash_file`` on ``device`` and write the
    db folder (reference src/project_everything.cpp:231-362)."""
    t0 = time.perf_counter()
    named = parse_hashes_file(hash_file)
    if verbose:
        log(f"Loaded {len(named)} hash sets from {hash_file}")
    names = [n for n, _ in named]
    vectors = project_many([h for _, h in named], dimension, device)
    if verbose:
        log(f"Time to compute all projected vectors: "
            f"{time.perf_counter() - t0:.4f} seconds")
    return DbFolder.write(index_folder, names, vectors, dimension,
                          use_int16=use_int16)


def project_hash_lines(lines: list[np.ndarray], dimension: int, *,
                       device) -> np.ndarray:
    """standalone_projection equivalent: one hash array per line -> (n, d)
    int32 (reference src/standalone_projection.cpp:11-46)."""
    return project_many(lines, dimension, device)
