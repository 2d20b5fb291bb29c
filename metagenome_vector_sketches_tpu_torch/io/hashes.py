"""The ``all_hashes.txt`` contract: one ``<accession>: h1 h2 ...`` line per
accession (reference writer src/project_everything.cpp:222-228, parser
:258-281; also the query input format of jaccard.py search, jaccard.py:75-94).
"""

from __future__ import annotations

import numpy as np


def write_hashes_file(path: str, named_sets) -> None:
    """Write (name, hash-iterable) pairs. Hashes are written sorted for
    determinism (the reference emits unordered_set order; consumers re-set
    them, so ordering is not load-bearing)."""
    with open(path, "w") as f:
        for name, hashes in named_sets:
            body = " ".join(map(str, sorted(int(x) for x in hashes)))
            f.write(f"{name}: {body}\n" if body else f"{name}:\n")


def _parse_hashes_native(path: str):
    """One-pass C tokenizer (native/sigscan.cpp hashparse_read) -> the same
    (name, sorted unique uint64 array) list, or None to fall back (missing
    lib, stale .so without the symbol, malformed token, IO error). At
    production scale the Python tokenizer is the ingest bottleneck
    (~34 s for 7e7 hashes at N=262k; the native pass is a few seconds)."""
    import ctypes
    from . import sigzip
    lib = sigzip._load_native()
    if lib is None or not hasattr(lib, "hashparse_read"):
        return None
    if not getattr(lib, "_hashparse_configured", False):
        lib.hashparse_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_int64)]
        lib.hashparse_read.restype = ctypes.c_int64
        lib.hashparse_free.argtypes = [ctypes.c_void_p]
        lib._hashparse_configured = True
    hp = ctypes.POINTER(ctypes.c_uint64)()
    op = ctypes.POINTER(ctypes.c_int64)()
    np_ = ctypes.POINTER(ctypes.c_char)()
    nlen = ctypes.c_int64()
    n = lib.hashparse_read(path.encode(), ctypes.byref(hp),
                           ctypes.byref(op), ctypes.byref(np_),
                           ctypes.byref(nlen))
    if n < 0:
        return None
    try:
        offsets = np.ctypeslib.as_array(op, shape=(n + 1,)).copy()
        total = int(offsets[-1])
        hashes = np.ctypeslib.as_array(hp, shape=(max(1, total),)) \
            [:total].copy()
        names_blob = ctypes.string_at(np_, nlen.value).decode()
    finally:
        lib.hashparse_free(hp)
        lib.hashparse_free(op)
        lib.hashparse_free(np_)
    names = names_blob.split("\n")[:n] if n else []
    out = []
    for i, name in enumerate(names):
        seg = hashes[offsets[i]:offsets[i + 1]]
        out.append((name, np.unique(seg) if len(seg)
                    else np.empty(0, dtype=np.uint64)))
    return out


def parse_hashes_file(path: str) -> list[tuple[str, np.ndarray]]:
    """Parse into (name, sorted unique uint64 array) pairs, line order kept."""
    native = _parse_hashes_native(path)
    if native is not None:
        return native
    out = []
    with open(path) as f:
        for line in f:
            colon = line.find(":")
            if colon < 0:
                continue
            name = line[:colon]
            rest = line[colon + 1:].split()
            arr = np.unique(np.array(rest, dtype=np.uint64)) if rest else \
                np.empty(0, dtype=np.uint64)
            out.append((name, arr))
    return out


def parse_query_hashes_file(path: str) -> tuple[list[str], list[np.ndarray]]:
    """jaccard.py-search-style strict parse: every non-empty line must be
    '<id>: hashes' (reference jaccard.py:75-94 exits on malformed lines)."""
    names, sets_ = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(":")
            if len(parts) != 2:
                raise ValueError(f"malformed query line in {path}: {line[:40]!r}")
            names.append(parts[0].strip())
            rest = parts[1].split()
            # the reference dedups query hashes through an unordered_set
            # (jaccard.py -> standalone_projection.cpp:29-33); a duplicated
            # hash must not contribute its +-1 pattern twice
            sets_.append(np.unique(np.array(rest, dtype=np.uint64)) if rest
                         else np.empty(0, dtype=np.uint64))
    return names, sets_
