"""ctypes binding to the C++ codec library (native/codecs.cpp).

The shared library is built on demand with the repo Makefile (a one-time
~1 s g++ invocation, cached in native/build/). If no compiler is available
the package silently falls back to the numpy spec implementation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libmvs_codecs.so")

_lib = None
_lock = threading.Lock()


def _build() -> bool:
    """Build the shared library, safe against concurrent first-time builds
    (tests spawn multiple fresh processes that all import on startup): an
    flock on a sidecar lockfile serializes the `make` runs; the loser of
    the race finds the .so already present and returns immediately. Without
    this, two g++ -o writes interleave on the final .so and a half-written
    file gets CDLL-loaded (silent permanent pyref fallback) or left corrupt
    with a fresh mtime (make then never rebuilds it)."""
    try:
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        lockfile = _LIB_PATH + ".lock"
        with open(lockfile, "w") as lf:
            try:
                import fcntl
                fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
            except ImportError:  # pragma: no cover - non-posix
                pass
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-s", "-C", _NATIVE_DIR],
                               check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH) and not _build():
            raise OSError("libmvs_codecs.so unavailable")
        lib = ctypes.CDLL(_LIB_PATH)
        u64 = ctypes.c_uint64
        pu8 = ctypes.POINTER(ctypes.c_uint8)
        pu64 = ctypes.POINTER(u64)
        lib.mvs_free.argtypes = [ctypes.c_void_p]
        for name in ("mvs_cv_encode", "mvs_rice_encode"):
            fn = getattr(lib, name)
            fn.argtypes = [pu64, u64, ctypes.POINTER(pu8), ctypes.POINTER(u64)]
            fn.restype = ctypes.c_int
        lib.mvs_ef_encode.argtypes = [pu64, u64, u64,
                                      ctypes.POINTER(pu8), ctypes.POINTER(u64)]
        lib.mvs_ef_encode.restype = ctypes.c_int
        for name in ("mvs_cv_decode", "mvs_rice_decode", "mvs_ef_decode"):
            fn = getattr(lib, name)
            fn.argtypes = [pu8, u64, u64, ctypes.POINTER(pu64),
                           ctypes.POINTER(u64), ctypes.POINTER(u64)]
            fn.restype = ctypes.c_int
        if hasattr(lib, "mvs_write_matrix_rows"):
            lib.mvs_write_matrix_rows.argtypes = [
                pu64, pu64, pu64, u64, ctypes.POINTER(pu8),
                ctypes.POINTER(u64), ctypes.POINTER(pu64),
                ctypes.POINTER(pu64)]
            lib.mvs_write_matrix_rows.restype = ctypes.c_int
        if hasattr(lib, "mvs_read_matrix_rows"):
            lib.mvs_read_matrix_rows.argtypes = [
                pu8, u64, pu64, pu64, u64, ctypes.POINTER(pu64),
                ctypes.POINTER(pu64), ctypes.POINTER(pu64)]
            lib.mvs_read_matrix_rows.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _as_u64_ptr(values: np.ndarray):
    values = np.ascontiguousarray(values, dtype=np.uint64)
    return values, values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _encode(fn, values: np.ndarray, *extra) -> bytes:
    lib = _load()
    values, ptr = _as_u64_ptr(values)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = fn(ptr, len(values), *extra, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError("codec encode failed")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.mvs_free(out)


def _decode(fn, buf, offset: int):
    lib = _load()
    # zero-copy view of the caller's buffer (bytes / memoryview / mmap /
    # ndarray): per-row decodes against a large shard blob must not copy
    # the whole blob per call
    arr = buf.reshape(-1).view(np.uint8) if isinstance(buf, np.ndarray) \
        else np.frombuffer(buf, dtype=np.uint8)
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    vals = ctypes.POINTER(ctypes.c_uint64)()
    n = ctypes.c_uint64()
    consumed = ctypes.c_uint64()
    rc = fn(ptr, len(arr), offset, ctypes.byref(vals), ctypes.byref(n),
            ctypes.byref(consumed))
    if rc != 0:
        raise ValueError("codec decode failed (truncated buffer?)")
    try:
        out = np.ctypeslib.as_array(vals, shape=(n.value,)).copy() if n.value \
            else np.empty(0, dtype=np.uint64)
    finally:
        lib.mvs_free(vals)
    return out, consumed.value  # as_array dtype is already uint64


def cv_encode(values) -> bytes:
    return _encode(_load().mvs_cv_encode, values)


def cv_decode(buf, offset: int = 0):
    return _decode(_load().mvs_cv_decode, buf, offset)


def rice_encode(values) -> bytes:
    return _encode(_load().mvs_rice_encode, values)


def rice_decode(buf, offset: int = 0):
    return _decode(_load().mvs_rice_decode, buf, offset)


def ef_encode(values, universe: int) -> bytes:
    return _encode(_load().mvs_ef_encode, values, int(universe))


def ef_decode(buf, offset: int = 0):
    return _decode(_load().mvs_ef_decode, buf, offset)


def read_matrix_rows(blob, addrs, first_cols):
    """Batched ACTIVE-format row decode: ONE native call for many rows.
    Returns (cols uint64, q uint64, bounds uint64 of len n_rows+1) with row
    k's neighbors at [bounds[k], bounds[k+1]), or None if the library lacks
    the entry point. Matches per-row cv_decode + rice_decode + prefix sum."""
    lib = _load()
    if not hasattr(lib, "mvs_read_matrix_rows"):
        return None
    arr = blob.reshape(-1).view(np.uint8) if isinstance(blob, np.ndarray) \
        else np.frombuffer(blob, dtype=np.uint8)
    ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    addrs, addrs_p = _as_u64_ptr(addrs)
    first, first_p = _as_u64_ptr(first_cols)
    n_rows = len(addrs)
    cols = ctypes.POINTER(ctypes.c_uint64)()
    q = ctypes.POINTER(ctypes.c_uint64)()
    bounds = ctypes.POINTER(ctypes.c_uint64)()
    rc = lib.mvs_read_matrix_rows(ptr, len(arr), addrs_p, first_p, n_rows,
                                  ctypes.byref(cols), ctypes.byref(q),
                                  ctypes.byref(bounds))
    if rc != 0:
        raise ValueError("batched row decode failed (corrupt shard?)")
    try:
        b = np.ctypeslib.as_array(bounds, shape=(n_rows + 1,)).copy() \
            if n_rows else np.zeros(1, dtype=np.uint64)
        total = int(b[-1]) if n_rows else 0
        c = np.ctypeslib.as_array(cols, shape=(total,)).copy() if total \
            else np.empty(0, dtype=np.uint64)
        v = np.ctypeslib.as_array(q, shape=(total,)).copy() if total \
            else np.empty(0, dtype=np.uint64)
    finally:
        lib.mvs_free(cols)
        lib.mvs_free(q)
        lib.mvs_free(bounds)
    return c, v, b  # as_array dtype is already uint64


def write_matrix_rows(cols, q, starts):
    """Batched ACTIVE-format matrix.bin body: ONE native call instead of two
    ctypes round trips per row. Returns (blob bytes, positions uint64 array,
    first_cols uint64 array), or None if the library lacks the entry point
    (stale build). Byte-identical with per-row cv_encode + rice_encode."""
    lib = _load()
    if not hasattr(lib, "mvs_write_matrix_rows"):
        return None
    cols, cols_p = _as_u64_ptr(cols)
    q, q_p = _as_u64_ptr(q)
    starts, starts_p = _as_u64_ptr(starts)
    # the C side trusts starts blindly: empty starts would wrap n_rows to
    # 2^64-1 through c_uint64, and a last entry beyond len(cols) drives
    # out-of-bounds reads
    if len(starts) < 1:
        raise ValueError("starts must hold at least the terminating bound")
    if len(cols) != len(q) or int(starts[-1]) != len(cols):
        raise ValueError(
            f"starts[-1]={int(starts[-1])} must equal len(cols)={len(cols)}"
            f"=len(q)={len(q)}")
    n_rows = len(starts) - 1
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    pos = ctypes.POINTER(ctypes.c_uint64)()
    first = ctypes.POINTER(ctypes.c_uint64)()
    rc = lib.mvs_write_matrix_rows(cols_p, q_p, starts_p, n_rows,
                                   ctypes.byref(out), ctypes.byref(out_len),
                                   ctypes.byref(pos), ctypes.byref(first))
    if rc != 0:
        raise ValueError("columns must be strictly ascending per row"
                         if rc == -2 else "batched row write failed")
    try:
        blob = ctypes.string_at(out, out_len.value)
        positions = np.ctypeslib.as_array(pos, shape=(n_rows,)).copy() \
            if n_rows else np.empty(0, dtype=np.uint64)
        first_cols = np.ctypeslib.as_array(first, shape=(n_rows,)).copy() \
            if n_rows else np.empty(0, dtype=np.uint64)
    finally:
        lib.mvs_free(out)
        lib.mvs_free(pos)
        lib.mvs_free(first)
    return blob, positions, first_cols
