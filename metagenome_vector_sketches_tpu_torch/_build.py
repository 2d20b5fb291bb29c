"""Build and bind the port's CUDA kernels.

``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` into one shared library
with a plain C interface, on first use, under ``build/torch_kernels/`` at the
root of the checkout; the library name carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
The library is loaded with ctypes: every pointer and the stream travel as
``c_void_p``. Each C entry point returns ``cudaGetLastError()`` after its
launch, and :func:`check` raises if it is not 0.

Nothing here runs at import: the CPU tests import every module.

Launch counts: each kernel wrapper calls :func:`count_launch` right after a
launch that succeeded, and nowhere else, so a run can show that its main
path went through the kernels (:func:`reset_launch_counts`,
:func:`launch_counts`).

Devices: every launch happens inside :func:`launch_stream`, which makes the
tensors' device current both for PyTorch (restored after the launch) and in
the library's own CUDA runtime (``mvs_set_device``), so the kernels launch
on any ``cuda:N``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# launch counters: "sweep" counts kernel APPEND (the sweep with survivor
# compaction), "count" kernel COUNT (the two-phase engine's counts sweep;
# both csrc/count.cu), "partials" kernel X's partials, "keep" kernel X with
# its retention epilogue (the fused engine's exact test; both
# csrc/partials.cu), "scan" kernel S (its SCORE epilogue: the int8 ANN
# engine), "gram" kernel G (a shard's rows of the MinHash
# incidence Gram), "select" kernel K (the ANN top-k selection), "cooc" kernel C (the
# MinHash shard's light co-occurrences) and "mhkeep" kernel M (its
# retention epilogue; both csrc/minhash.cu)
KERNELS = ("projection", "sweep", "partials", "scan", "gram", "select",
           "count", "keep", "cooc", "mhkeep")
_launches = {k: 0 for k in KERNELS}

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the entry points (an int cudaError_t returned, unless
# RESTYPES says otherwise)
_SIGNATURES = {
    # hashes, offsets, item_off, n_sets, max_items, chunk, d, out, stream
    "mvs_project": [_P, _P, _P, _I, _LL, _I, _I, _P, _P],
    # planes_i, planes_j, thr_i, thr_j, P, d, d_pad, rows_i, rows_j,
    # coords, n_tiles, tile_r, tile_c, weights(host), slack_rel, slack_abs,
    # mask_self, diag_offset, counts, rc, total, cap, stream
    "mvs_append": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P, _I, _I, _I, _P,
                   _F, _F, _I, _LL, _P, _P, _P, _LL, _P],
    # planes_i, planes_j, thr_i, thr_j, P, d, d_pad, rows_i, rows_j, coords,
    # n_tiles, row_t0, n_col_tiles, tile_r, tile_c, weights(host),
    # slack_rel, slack_abs, counts, stream
    "mvs_count": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P, _I, _I, _I, _I,
                  _I, _P, _F, _F, _P, _P],
    # q_planes, db_planes, P, d_pad, stride_q, stride_db, rows, cols,
    # inv_n, valid, weights(host), scores, ld, stream
    "mvs_scan": [_P, _P, _I, _I, _LL, _LL, _I, _I, _P, _I, _P, _P, _LL, _P],
    # xs, x_stride, ys, y_stride, L, d_pad, nx, ny, rc, n, out, bad, stream
    "mvs_partials": [_P, _LL, _P, _LL, _I, _I, _LL, _LL, _P, _LL, _P, _P,
                     _P],
    # xs, x_stride, ys, y_stride, L, d_pad, nx, ny, rc, n, ns, row_base,
    # col_base, begin_row, end_row, total, d, int16, tile, rt0, rt1, out,
    # cap, counters, stream
    "mvs_keep": [_P, _LL, _P, _LL, _I, _I, _LL, _LL, _P, _LL, _P, _LL, _LL,
                 _LL, _LL, _LL, _LL, _I, _LL, _LL, _LL, _P, _LL, _P, _P],
    # a, n, ld, c, ldc, stream
    # a, n, ld, row0, rows, c, ldc, stream
    "mvs_gram_rows": [_P, _I, _I, _I, _I, _P, _LL, _P],
    # sets, off, n_post, b, e, c, ldc, count, stream
    "mvs_cooc": [_P, _P, _LL, _I, _I, _P, _LL, _P, _P],
    # c, ldc, rows, n, b, sizes, out, cap, kept, stream
    "mvs_minhash_keep": [_P, _LL, _I, _I, _I, _P, _P, _LL, _P, _P],
    # scores, keys, ld, rows, width, base, valid, none, kc, regime, work,
    # out_key, out_lane, best, w0, wm, m_key, m_pos, stream
    "mvs_select": [_P, _P, _LL, _I, _I, _LL, _LL, _LL, _I, _I, _P, _P, _P,
                   _P, _I, _I, _P, _P, _P],
    # regime, rows, width, kc (returns bytes: a long long)
    "mvs_select_work_bytes": [_I, _I, _I, _I],
}
# entry points that return something else than an int cudaError_t
RESTYPES = {"mvs_select_work_bytes": ctypes.c_longlong}


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def launch_counts() -> dict:
    return dict(_launches)


def count_launch(kernel: str) -> None:
    _launches[kernel] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _library_path() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmvs_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source state has no library yet;
    returns the library path. Each source compiles in its own nvcc
    process, all started together, then one link."""
    path = _library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cus]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", o, cu]
                        for cu, o in zip(cus, objs))]
    try:
        for cmd, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}\n{err}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n"
                               f"{res.stderr}")
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, path)        # atomic: a concurrent process never sees half
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            lib.mvs_error_string.argtypes = [ctypes.c_int]
            lib.mvs_error_string.restype = ctypes.c_char_p
            lib.mvs_set_device.argtypes = [ctypes.c_int]
            lib.mvs_set_device.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if rc != 0:
        msg = library().mvs_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({msg})")


@contextlib.contextmanager
def launch_stream(device):
    """For the launches inside the block: ``device`` current for PyTorch
    (its previous device comes back after the block) and in the kernel
    library's own runtime (nvcc links it against a static CUDA runtime
    whose current device is per thread and separate from PyTorch's).
    Yields PyTorch's current stream on the device as a c_void_p, the
    launch's stream argument."""
    import torch
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with torch.cuda.device(index):
        rc = library().mvs_set_device(index)
        if rc != 0:
            raise RuntimeError(f"cudaSetDevice({index}) failed with error "
                               f"{rc}")
        yield ctypes.c_void_p(torch.cuda.current_stream(index).cuda_stream)
