"""Time several builds of ``csrc/sweep.cu`` (kernels S and G) in turns on
one GPU, each checked against the plain PyTorch versions first.

    python -m metagenome_vector_sketches_tpu_torch.compare_kernels \\
        old=path/to/old_sweep.cu new=metagenome_vector_sketches_tpu_torch/csrc/sweep.cu

Every source must export the C entry points of ``_build._SIGNATURES``
that it has (``mvs_sweep``, ``mvs_scan``, ``mvs_gram``); each is compiled
on its own (nvcc, sm_90a, the port's flags) and swapped in as the port's
kernel library. Timed at the shapes ``chip_smoke.py`` uses: S APPEND and
COUNT on 10 tiles of 2048^2 at P = 3, S SCORE on 256 x 262,144 at P = 3,
G on one 8,192 x 16,384 incidence chunk; CUDA events over 20 calls, the
builds in the order given, then reversed, twice; medians printed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import _build
from .ops import minhash as mh
from .ops import pairwise as pw
from .ops import pairwise_math as pm


def _load(name: str, src: str, out_dir: str) -> ctypes.CDLL:
    out = os.path.join(out_dir, f"lib_{name}.so")
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC_DIR, "-Xptxas", "-v", "-shared", "-o",
                        out, src], capture_output=True, text=True)
    print(f"[{name}] nvcc rc={r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for ln in r.stderr.splitlines():
        if any(k in ln for k in ("error", "warning", "Used", "spill")):
            print(f"[{name}]   {ln.strip()}")
    if r.returncode:
        raise RuntimeError(f"{src} does not build")
    lib = ctypes.CDLL(out)
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.mvs_error_string.argtypes = [ctypes.c_int]
    lib.mvs_error_string.restype = ctypes.c_char_p
    return lib


def _ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    builds = [a.split("=", 1) for a in (argv or sys.argv[1:])]
    if not builds or any(len(b) != 2 for b in builds):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out_dir = tempfile.mkdtemp(prefix="compare_kernels_")
    libs = {name: _load(name, src, out_dir) for name, src in builds}

    g = torch.Generator(device="cuda").manual_seed(1)
    D, tile, R = 2048, 2048, 262144
    V = (torch.randn((4 * tile, D), generator=g, device="cuda") * 150) \
        .round_().clamp_(-600, 600).to(torch.int32)
    V[1:5] = V[0]
    planes = torch.zeros((3, 4 * tile, D), dtype=torch.int8, device="cuda")
    pw.planes_update(planes, pw.decompose_limbs(V, 2), 0)
    thr = ((V.double() ** 2).sum(1) / D
           + pm.threshold_adjust(2, 600, D)).float().contiguous()
    coords = np.array([(r, c) for r in range(4) for c in range(r, 4)],
                      dtype=np.int32)
    cap = 1 << 22
    db = torch.randint(-64, 64, (3, R, D), generator=g, device="cuda",
                       dtype=torch.int8)
    qp = torch.randint(-64, 64, (3, 256, D), generator=g, device="cuda",
                       dtype=torch.int8)
    inv = torch.rand(R, generator=g, device="cuda")
    A = (torch.rand((8192, 16384), generator=g, device="cuda") < 1 / 128) \
        .to(torch.int8)
    C = torch.zeros((8192, 8192), dtype=torch.int32, device="cuda")

    want_s = pw.sweep_extract_plain(planes, thr, planes, thr, coords, tile,
                                    cap, True, D)
    n = int(want_s[2].item())
    want_q = pw.scan_scores_plain(qp, db, inv, R - 77)
    want_g = mh.gram_accumulate_plain(torch.zeros_like(C), A)

    def key(rc):
        return sorted(map(tuple, rc[:n].tolist()))

    for name, lib in libs.items():
        _build._lib = lib
        got = pw.sweep_extract(planes, thr, planes, thr, coords, tile, cap,
                               True, D)
        ok = (int(got[2].item()) == n and torch.equal(got[1], want_s[1])
              and key(got[0]) == key(want_s[0]))
        ok = ok and torch.equal(pw.scan_scores(qp, db, inv, R - 77), want_q)
        ok = ok and torch.equal(mh.mirror_upper(mh.gram_accumulate(
            torch.zeros_like(C), A)), want_g)
        print(f"[{name}] S APPEND ({n} survivors), SCORE and G equal to the "
              f"plain versions: {ok}", flush=True)
        if not ok:
            return 3
    del want_q, want_g

    runs = {name: {"S": [], "COUNT": [], "SCORE": [], "G": []}
            for name in libs}
    order = [name for name, _ in builds]
    for name in (order + order[::-1]) * 2:
        _build._lib = libs[name]
        r = runs[name]
        r["S"].append(_ms(lambda: pw.sweep_extract(
            planes, thr, planes, thr, coords, tile, cap, True, D)))
        r["COUNT"].append(_ms(lambda: pw.launch_sweep(
            planes, thr, planes, thr, coords, tile, tile, D, False, False)))
        r["SCORE"].append(_ms(lambda: pw.scan_scores(qp, db, inv, R - 77)))
        r["G"].append(_ms(lambda: mh.gram_accumulate(C, A)))
    card = torch.cuda.get_device_name(0)
    for name, r in runs.items():
        print(f"[{name}] {card}: " + "  ".join(
            f"{k} ms {[round(x, 4) for x in v]} median {np.median(v):.4f}"
            for k, v in r.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
