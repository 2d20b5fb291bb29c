"""Ingest: ``convert`` (signature folder -> ``all_hashes.txt``) and
``sketch`` (``all_hashes.txt`` -> db folder through the port's projection,
on the caller's device), mirroring the two subcommands of the reference's
project_everything (src/project_everything.cpp:181-362).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import sigzip
from .dbfolder import DbFolder
from .hashes import parse_hashes_file, write_hashes_file
from ..ops.projection import project_many
from ..utils.log import log


def convert(folder: str, output_file: str, num_threads: int = 1,
            ksize: int = 31, verbose: bool = True) -> list[tuple[str, set]]:
    """Load every signature file in ``folder`` and write the hashes file."""
    t0 = time.perf_counter()
    files = list(sigzip.iter_signature_files(folder))
    # a dotfile (.DS_Store) yields an EMPTY accession name (stem up to the
    # first '.') — its hashes-file/vector_norms.txt line could not round-trip
    # (readers split on whitespace), so skip such files up front
    skipped = [f for f in files if not sigzip.accession_name(f)]
    for f in skipped:
        log(f"Skipping {f}: empty accession name (dotfile?)")
    files = [f for f in files if sigzip.accession_name(f)]

    def load(path):
        try:
            return sigzip.accession_name(path), sigzip.read_sig_zip(path, ksize=ksize)
        except Exception as e:
            # a stray non-zip file (.DS_Store, half-download) must not kill
            # a multi-hour ingest: the reference logs 'Failed to unzip' and
            # continues with an empty set (project_everything.cpp:98-103)
            log(f"Failed to read {path}: {e}")
            return sigzip.accession_name(path), set()

    # iterate pool.map LAZILY so per-file progress prints as files finish
    # (buffering all logs to the end left a multi-hour ingest silent, with
    # no stuck-detection signal; the reference logs per file)
    results = []
    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        for i, (name, hs) in enumerate(pool.map(load, files)):
            results.append((name, hs))
            if verbose:
                log(f"Processed {files[i]}, hashes size {len(hs)}, "
                    f"file number {i}")
    write_hashes_file(output_file, results)
    if verbose:
        log(f"Time to convert all signatures: {time.perf_counter() - t0:.4f} seconds")
    return results


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
