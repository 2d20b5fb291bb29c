"""In-process sourmash ``.sig.zip`` reader.

The reference shells out to ``unzip``/``gunzip`` and hand-scans the JSON for
``"ksize"``/``"mins"`` (src/project_everything.cpp:73-151). We do the whole
thing in-process — no subprocesses, no temp files — and take the union of
``mins`` over every signature record with the requested ksize (the reference
ingests only ksize==31, src/project_everything.cpp:116).

Two paths, result-equal (tested on every toy accession):
- native/sigscan.cpp via ctypes — zip central-directory reader + zlib
  inflate + sequential "ksize"/"mins" scan, the ingest hot path;
- zipfile + gzip + json — pure-python fallback when the native library is
  unavailable or reports a structural surprise (zip64, unusual layout).
"""

from __future__ import annotations

import ctypes
import gzip
import json
import os
import subprocess
import threading
import zipfile

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libmvs_sigscan.so")
_lib = None
_lib_failed = False
_lock = threading.Lock()


def _load_native():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            src = os.path.join(_NATIVE_DIR, "sigscan.cpp")
            if not os.path.exists(_LIB_PATH) or (
                    os.path.exists(src)
                    and os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
                subprocess.run(["make", "-s", "-C", _NATIVE_DIR],
                               check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.sigscan_read.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
            lib.sigscan_read.restype = ctypes.c_int64
            lib.sigscan_free.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def _read_sig_zip_native(path: str, ksize: int):
    """-> set[int] or None (fall back) on any native-side error."""
    lib = _load_native()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint64)()
    n = lib.sigscan_read(path.encode(), ksize, ctypes.byref(out))
    if n < 0:
        return None
    try:
        if n == 0:
            return set()
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.sigscan_free(out)
    # the set dedupes by itself; np.unique here was a redundant full sort
    return set(int(h) for h in arr)


def accession_name(path: str) -> str:
    """Base name up to the first '.' of the file stem.

    Matches fs::path(file).stem() + substr(0, find('.')) in the reference
    (src/project_everything.cpp:163-164): "DRR000001.unitigs.fa.sig.zip"
    -> stem "DRR000001.unitigs.fa.sig" -> "DRR000001".
    """
    stem = os.path.basename(path)
    if stem.endswith(".zip"):
        stem = stem[:-4]
    return stem.split(".", 1)[0]


def read_sig_zip(path: str, ksize: int = 31) -> set[int]:
    """Extract the union of FracMinHash 'mins' at the given ksize."""
    native = _read_sig_zip_native(path, ksize)
    if native is not None:
        return native
    return _read_sig_zip_python(path, ksize)


def _iter_json_documents(text: bytes):
    """Yield every top-level JSON document in text. A .sig.gz with
    CONCATENATED gzip members decompresses to back-to-back documents; the
    reference's `gunzip -c` + hand-scan reads them all
    (src/project_everything.cpp:73-151), so both of our paths must too."""
    dec = json.JSONDecoder()
    s = text.decode()
    pos = 0
    while True:
        while pos < len(s) and s[pos] in " \t\r\n":
            pos += 1
        if pos >= len(s):
            return
        doc, pos = dec.raw_decode(s, pos)
        yield doc


def _read_sig_zip_python(path: str, ksize: int = 31) -> set[int]:
    """Pure-python fallback (zipfile + gzip + json)."""
    hashes: set[int] = set()
    with zipfile.ZipFile(path) as zf:
        for member in zf.namelist():
            if not member.endswith(".sig.gz"):
                continue
            raw = zf.read(member)
            text = gzip.decompress(raw)
            for records in _iter_json_documents(text):
                if isinstance(records, dict):
                    records = [records]
                for rec in records:
                    for sig in rec.get("signatures", []):
                        if sig.get("ksize") == ksize:
                            hashes.update(int(h) for h in sig.get("mins", []))
    return hashes


def iter_signature_files(folder: str):
    """Deterministic (sorted) listing of signature files in a folder.

    The reference uses raw directory-iteration order
    (src/project_everything.cpp:189-191), which is filesystem-dependent; we
    sort lexicographically so runs are reproducible. Downstream artifacts are
    keyed by vector_norms.txt line order, so this is self-consistent.
    """
    names = sorted(os.listdir(folder))
    for name in names:
        full = os.path.join(folder, name)
        if os.path.isfile(full):
            yield full
