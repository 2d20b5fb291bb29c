"""Native parsers of the entries' text inputs, and the process's slot of
parsed db norms.

The search entry (``ann.search.search_index``) reads a db folder's
``vector_norms.txt`` and a query file on every request, and the shard
entry (``matrix.compute.compute_pairwise_shard``) reads the same norms on
every shard. The Python parsers of ``io/dbfolder.py`` and ``io/hashes.py``
tokenise line by line, which took most of a search request's time.

- :func:`parse_norms` and :func:`parse_queries` run one strict pass of
  ``csrc/textparse.cpp``, compiled with the system's C++ compiler on first
  use under ``build/textparse/`` at the root of the checkout (the library
  name carries a hash of the source and flags, as the CUDA kernels' does).
  Their results equal ``DbFolder.names_and_norms`` and
  ``hashes.parse_query_hashes_file`` bit for bit. Input that the native
  pass does not take exactly as they do (a byte above 0x7f, a norm other
  than a plain decimal, a hash with a sign, a non-digit or above
  2^64 - 1, a query line without exactly one ':', an unreadable file), or
  a library that does not build, goes to those functions, which return or
  raise what they always did. ``PATHS`` counts the calls of each path.
- :func:`db_norms` and :func:`db_names_and_norms` keep one db's parsed
  norms and names for the process, keyed by the file's absolute path,
  mtime and size: a server or a shard process parses its db's norms once.
  ``ann.search.clear_index_cache`` and ``matrix.compute.clear_device_cache``
  empty it (:func:`clear_norms`). Query files are never kept: each request
  brings its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .dbfolder import DbFolder
from .hashes import parse_query_hashes_file

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "textparse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "textparse")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")

# calls that the native pass answered, and calls that went to the Python
# parsers
PATHS = {"native": 0, "fallback": 0}

_lib = None
_lib_failed = False
_lock = threading.Lock()


def _library_path() -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmvs_textparse_{h.hexdigest()[:16]}.so")


def _build() -> str:
    """Compile the parsers if this source has no library yet; returns the
    library path. The compiler writes a file of its own, which replaces
    the library's name at once, so a concurrent process never loads half
    of one."""
    path = _library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _library():
    """The native library, built on first use; None when it cannot be
    built or loaded."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
            pp = ctypes.POINTER
            lib.textparse_norms.argtypes = [
                ctypes.c_char_p, pp(pp(ctypes.c_double)),
                pp(pp(ctypes.c_char)), pp(ctypes.c_int64)]
            lib.textparse_norms.restype = ctypes.c_int64
            lib.textparse_queries.argtypes = [
                ctypes.c_char_p, pp(pp(ctypes.c_uint64)),
                pp(pp(ctypes.c_int64)), pp(pp(ctypes.c_char)),
                pp(ctypes.c_int64)]
            lib.textparse_queries.restype = ctypes.c_int64
            lib.textparse_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.SubprocessError, AttributeError):
            _lib_failed = True
        return _lib


def _split(blob: bytes, n: int) -> list[str]:
    """The n names of a '\\n'-joined ASCII blob."""
    return blob.decode("ascii").split("\n") if n else []


def _native_norms(path: str):
    """-> (the names' blob, their count, the norms), or None."""
    lib = _library()
    if lib is None:
        return None
    norms = ctypes.POINTER(ctypes.c_double)()
    names = ctypes.POINTER(ctypes.c_char)()
    nlen = ctypes.c_int64()
    n = lib.textparse_norms(os.fsencode(path), ctypes.byref(norms),
                            ctypes.byref(names), ctypes.byref(nlen))
    if n < 0:
        return None
    try:
        values = np.ctypeslib.as_array(norms, shape=(max(1, n),))[:n].copy()
        blob = ctypes.string_at(names, nlen.value)
    finally:
        lib.textparse_free(norms)
        lib.textparse_free(names)
    return blob, n, values


def _native_queries(path: str):
    """-> (the names, the sorted unique hashes of each line), or None."""
    lib = _library()
    if lib is None:
        return None
    hashes = ctypes.POINTER(ctypes.c_uint64)()
    offsets = ctypes.POINTER(ctypes.c_int64)()
    names = ctypes.POINTER(ctypes.c_char)()
    nlen = ctypes.c_int64()
    n = lib.textparse_queries(os.fsencode(path), ctypes.byref(hashes),
                              ctypes.byref(offsets), ctypes.byref(names),
                              ctypes.byref(nlen))
    if n < 0:
        return None
    try:
        off = np.ctypeslib.as_array(offsets, shape=(n + 1,)).copy()
        total = int(off[-1])
        flat = np.ctypeslib.as_array(hashes, shape=(max(1, total),)) \
            [:total].copy()
        blob = ctypes.string_at(names, nlen.value)
    finally:
        lib.textparse_free(hashes)
        lib.textparse_free(offsets)
        lib.textparse_free(names)
    return _split(blob, n), [flat[off[i]:off[i + 1]] for i in range(n)]


def _norms_or_fallback(db_folder: str):
    """-> (the names, or None where they are still the native blob; the
    blob and its count of names, or None; the norms)."""
    got = _native_norms(os.path.join(db_folder, "vector_norms.txt"))
    if got is None:
        PATHS["fallback"] += 1
        names, norms = DbFolder(db_folder).names_and_norms()
        return names, None, norms
    PATHS["native"] += 1
    blob, n, norms = got
    return None, (blob, n), norms


def parse_norms(db_folder: str) -> tuple[list[str], np.ndarray]:
    """``DbFolder(db_folder).names_and_norms()``: the names and the float64
    norms of the folder's vector_norms.txt, parsed natively."""
    names, blob, norms = _norms_or_fallback(db_folder)
    return (names if names is not None else _split(*blob)), norms


def parse_queries(path: str) -> tuple[list[str], list[np.ndarray]]:
    """``parse_query_hashes_file(path)``: each query line's name and its
    sorted unique uint64 hashes, parsed natively."""
    got = _native_queries(path)
    if got is None:
        PATHS["fallback"] += 1
        return parse_query_hashes_file(path)
    PATHS["native"] += 1
    return got


# the slot: (key, read-only norms, names or None, (blob, count) or None)
# of the last db parsed, replaced whole. The names stay the native pass's
# blob until a caller asks for them: a shard needs only the norms, and
# making 262,144 str objects takes longer than the parse.
_SLOT = None


def clear_norms() -> None:
    global _SLOT
    _SLOT = None


def _slot(db_folder: str) -> tuple:
    global _SLOT
    path = os.path.join(db_folder, "vector_norms.txt")
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if _SLOT is None or _SLOT[0] != key:
        names, blob, norms = _norms_or_fallback(db_folder)
        norms.flags.writeable = False
        _SLOT = (key, norms, None if names is None else tuple(names), blob)
    return _SLOT


def db_norms(db_folder: str) -> np.ndarray:
    """The float64 norms of the db folder's vector_norms.txt, parsed once a
    process for each version of the file: the slot's own read-only array."""
    return _slot(db_folder)[1]


def db_names_and_norms(db_folder: str) -> tuple[tuple[str, ...],
                                                np.ndarray]:
    """:func:`db_norms` and the file's names, from one look at the slot:
    the slot's own tuple and array."""
    global _SLOT
    key, norms, names, blob = _slot(db_folder)
    if names is None:
        names = tuple(_split(*blob))
        _SLOT = (key, norms, names, None)
    return names, norms
