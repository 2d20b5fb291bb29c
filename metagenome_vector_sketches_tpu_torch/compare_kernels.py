"""Time several builds of the port's kernel sources in turns on one GPU,
each checked against the plain PyTorch versions first.

    python -m metagenome_vector_sketches_tpu_torch.compare_kernels \\
        old=path/to/old_sweep.cu new=metagenome_vector_sketches_tpu_torch/csrc/sweep.cu
    python -m metagenome_vector_sketches_tpu_torch.compare_kernels \\
        --projection old=build/parent/projection.cu \\
                     new=metagenome_vector_sketches_tpu_torch/csrc/projection.cu \\
        --partials old=build/parent/partials.cu \\
                   new=metagenome_vector_sketches_tpu_torch/csrc/partials.cu
    python -m metagenome_vector_sketches_tpu_torch.compare_kernels \\
        --append old=build/parent/sweep.cu \\
                 new=metagenome_vector_sketches_tpu_torch/csrc/count.cu \\
        --count old=build/parent/count.cu \\
                new=metagenome_vector_sketches_tpu_torch/csrc/count.cu

Each source is compiled on its own (nvcc, sm_90a, the port's flags,
``-Xptxas -v``) and swapped in as the port's kernel library; ``--sass
DIR`` also writes each build's ``cuobjdump -sass`` text into DIR.

- ``sweep.cu`` builds (positional): kernels S SCORE and G at the shapes
  ``chip_smoke.py`` uses: SCORE on 256 x 262,144 at P = 3, G on one 8,192
  x 16,384 incidence chunk.
- ``--append`` builds: kernel APPEND on the fused engine's triangle of 10
  tiles of 2048^2 (a 4 x 4 grid of 8,192 rows, self-pairs masked), d =
  2048, at P = 3 and at P = 6 (``count_state``), as the wrapper call over
  a tile list already on the card, as the kernel alone and as the host
  time of a call, each build's survivor sets, counts and totals checked
  against the plain version first. A ``count.cu`` build runs
  ``mvs_append``; a build of the sweep.cu from before APPEND moved to
  count.cu runs kernel S's APPEND epilogue (``mvs_sweep``; with the
  COUNT epilogue's ``append`` flag, 24 parameters, called with append =
  1) the way that parent's ``launch_sweep`` called it, the coordinates
  copied to the card on every call.
- ``--count`` builds: the two-phase engine's counts sweep on 16 tiles of
  2048^2 (a 4 x 4 grid of 8,192 rows), d = 2048, at P = 3 and at P = 6
  (an int16-like db, L = 3), as the wrapper call over a tile list already
  on the card, as the kernel alone and as the host time of a call. A
  ``count.cu`` build runs kernel COUNT (``mvs_count``); a build of the
  sweep.cu before it runs kernel S's COUNT epilogue (``mvs_sweep``,
  append = 0) the way that parent's ``count_tiles`` called it: every tile
  expanded on the host into the JAX engine's sub-blocks
  (``engine_blocks``), the coordinates copied to the card, one launch, the
  sub-block counts summed to the tile by a second op.

``--append`` and ``--count`` print once: the plain version, the bound and
the ``torch._int_mm`` yardstick of the GEMM core.

- ``--shards name=TREE ...`` (``--n`` rows, default 262,144): whole
  shards of two checkouts of the repository in turns, each turn a
  process with ``PYTHONPATH=TREE`` (its own kernel library, built before
  the first timed turn): chip_smoke.py phase 2's db (synthetic sets with
  planted groups, sketched once on the card), the fused shard, then the
  two-phase shard (finalize device) on the planes the fused one staged,
  each inside a torch.profiler trace; each shard's wall, ``LAST_STAGES``,
  the device ms of each of its kernels and the SM clock and power
  sampled during its sweeps (:class:`Clocks`) printed, every shard
  byte-equal to the first tree's.
- ``projection.cu`` builds: kernel P at the main path's batch (32,768 sets
  x 256 hashes, d = 2048) and at a skewed batch (the toy fixture's real
  set sizes, 3 to 80,772 hashes, drawn from a seed to fill one
  ``project_many`` batch: ``bench_data.skewed_set_sizes``), at each
  work-item size of ``--chunks`` (the first cut, which has no items, once).
- ``partials.cu`` builds: kernel X at the main path's shape (20,762 random
  pairs plus the 8,192 self-pairs of 4 x 2048 rows, L = 2) and the ANN
  path's (256 queries x 114 pooled rows of a 262,144-row chunk, two
  operands, L = 2).
- ``select.cu`` builds (``--select``): kernel K at the int8 search's shape
  (256 x 262,144 scores merged into a pool of 114, kc = 114), the f32
  search's (kc = 50) and the adaptive search's level 4 (kc = 4,556) and
  deepest level (kc = R), as the wrapper call, as its kernels alone (each
  printed) and as the host time of a call at the int8 shape; a build with
  the first cut's ``mvs_select`` (20 parameters) is called through that
  interface. Yardsticks printed once: ``torch.sort`` of the packed keys
  and ``torch.topk`` at each kc.

P and X are timed as the wrapper call and as the kernel alone (its
device time in a torch.profiler trace). P's wrapper time is CUDA events
over 20 calls back to back. X reads rows that a timed loop would leave in
the L2, so each X call starts from an idle device with a cold L2
(:func:`cold_ms`; the profiler's loop flushes the same way). A
``projection.cu`` or
``partials.cu`` source is called through the interface its entry point
declares: the first cut's (``mvs_project`` with 6 parameters,
``mvs_partials`` with 10; its wrapper's synchronising range check
included) or the current one (the port's wrappers). The builds run in the
order given, then reversed, twice; every turn's time and the medians are
printed with the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import _build
from .bench_data import BASE_HASHES, csr_hashes, skewed_set_sizes
from .ops import minhash as mh
from .ops import pairwise as pw
from .ops import pairwise_math as pm
from .ops import pallas_pairwise as pp
from .ops import projection as pj

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# where --sass writes each build's cuobjdump -sass text (None: not at all)
_SASS_DIR = None
# the first cut's entry points (the earlier csrc/projection.cu and
# csrc/partials.cu, before work items and the range flag)
FIRST_CUT = {"mvs_project": [_P, _P, _I, _I, _P, _P],
             "mvs_partials": [_P, _LL, _P, _LL, _I, _I, _P, _LL, _P, _P],
             "mvs_select": [_P, _P, _LL, _I, _I, _LL, _LL, _LL, _I, _P, _P,
                            _P, _P, _P, _P, _I, _I, _P, _P, _P]}
# mvs_sweep of the sweep.cu from before kernel APPEND moved to count.cu
# (planes_i, planes_j, thr_i, thr_j, P, d, d_pad, stride_i, stride_j,
# coords, n_tiles, tile_r, tile_c, weights(host), slack_rel, slack_abs,
# mask_self, diag_offset, counts, rc, total, cap, stream) and, before kernel
# COUNT, the same with an append flag (0: the COUNT epilogue) after
# diag_offset
_F = ctypes.c_float
PARENT_SWEEP = [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P, _I, _I, _I, _P,
                _F, _F, _I, _LL, _P, _P, _P, _LL, _P]
WITH_COUNT = PARENT_SWEEP[:18] + [_I] + PARENT_SWEEP[18:]


class _WithCount:
    """A build of the sweep.cu before kernel COUNT (``raw``): its mvs_sweep
    is called through the current interface with append = 1 (APPEND)."""

    def __init__(self, raw):
        self.raw = raw

    def __getattr__(self, name):
        return getattr(self.raw, name)

    def mvs_sweep(self, *args):
        return self.raw.mvs_sweep(*args[:18], 1, *args[18:])


def _n_params(src: str, fn: str) -> int:
    with open(src) as f:
        m = re.search(rf"MVS_EXPORT\s+int\s+{fn}\s*\(([^)]*)\)", f.read())
    if m is None:
        raise ValueError(f"{src} does not declare {fn}")
    return len(m.group(1).split(","))


def _load(name: str, src: str, out_dir: str) -> ctypes.CDLL:
    out = os.path.join(out_dir, f"lib_{name}_{os.path.basename(src)}.so")
    t0 = time.perf_counter()
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC_DIR, "-Xptxas", "-v", "-shared", "-o",
                        out, src], capture_output=True, text=True)
    print(f"[{name}] {os.path.basename(src)}: nvcc rc={r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for ln in r.stderr.splitlines():
        if any(k in ln for k in ("error", "warning", "Used", "spill",
                                 "Compiling", "Performance")):
            print(f"[{name}]   {ln.strip()}")
    if r.returncode:
        raise RuntimeError(f"{src} does not build")
    if _SASS_DIR:
        dump = subprocess.run(
            [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
             "-sass", out], capture_output=True, text=True, check=True).stdout
        path = os.path.join(_SASS_DIR, f"{name}_{os.path.basename(src)}.sass")
        with open(path, "w") as f:
            f.write(dump)
        print(f"[{name}] SASS in {path}")
    lib = ctypes.CDLL(out)
    with_count = hasattr(lib, "mvs_sweep") and \
        _n_params(src, "mvs_sweep") == len(WITH_COUNT)
    if hasattr(lib, "mvs_sweep"):
        lib.mvs_sweep.argtypes = WITH_COUNT if with_count else PARENT_SWEEP
        lib.mvs_sweep.restype = ctypes.c_int
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            first = fn in FIRST_CUT and \
                _n_params(src, fn) == len(FIRST_CUT[fn])
            getattr(lib, fn).argtypes = FIRST_CUT[fn] if first else argtypes
            getattr(lib, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
            setattr(lib, f"{fn}_first_cut", first)
    if hasattr(lib, "mvs_error_string"):
        lib.mvs_error_string.argtypes = [ctypes.c_int]
        lib.mvs_error_string.restype = ctypes.c_char_p
    lib.mvs_set_device.argtypes = [ctypes.c_int]    # common.cuh's
    lib.mvs_set_device.restype = ctypes.c_int
    return _WithCount(lib) if with_count else lib


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


# written before each cold call: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 1 << 28


def l2_flush():
    """-> a function that writes a 256 MiB device buffer, evicting what the
    L2 held."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    return lambda: buf.fill_(0)


def cold_ms(fn, reps: int = 20) -> float:
    """Mean time of one fn() call from an idle device with a cold L2: before
    each call the L2 is flushed and the device synchronised, then CUDA
    events bracket the call alone (its host work up to the launch
    included)."""
    flush = l2_flush()
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush()
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def kernel_name(lib) -> str:
    """The profiler name of a build's sweep kernel: retention_kernel
    (kernels COUNT and APPEND of count.cu), count_kernel (the count.cu
    before APPEND joined it), gemm_kernel (kernel S of a sweep.cu)."""
    if hasattr(lib, "mvs_append"):
        return "retention_kernel"
    return "count_kernel" if hasattr(lib, "mvs_count") else "gemm_kernel"


def kernel_times(fn, name: str, reps: int = 10, cold: bool = False):
    """{kernel: mean device ms per fn() call} of the kernels whose name
    holds ``name``, from a torch.profiler trace (each kernel alone, without
    the wrapper's host work or its other launches); ``cold``: the L2 is
    flushed before each call. Empty when the trace holds fewer launches of
    a kernel than calls (the profiler dropped events): not measured."""
    from torch.profiler import ProfilerActivity, profile
    if cold:
        flush, call = l2_flush(), fn
        def fn():
            flush()
            call()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if name in e.key and getattr(e, "self_device_time_total", 0)]
    if any(e.count < reps for e in found):
        return {}
    return {e.key: e.self_device_time_total / reps / 1e3 for e in found}


def kernel_ms(fn, name: str, reps: int = 10, cold: bool = False):
    """Mean device time per fn() call of the kernels whose name holds
    ``name`` (:func:`kernel_times` summed); None if the trace holds no such
    device time."""
    times = kernel_times(fn, name, reps, cold)
    return sum(times.values()) if times else None


class Clocks:
    """Card 0's SM clock (MHz) and power draw (W) while the block runs: one
    ``nvidia-smi -lms 50`` process, started (and its first sample read)
    before the block, its lines read in a thread; ``samples`` holds
    (time.perf_counter seconds, MHz, W)."""

    def __enter__(self):
        self.samples = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._first = threading.Event()
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        self._first.wait(timeout=20)
        return self

    def _read(self):
        for ln in self._proc.stdout:
            t = time.perf_counter()
            try:
                mhz, w = (float(x) for x in ln.split(","))
            except ValueError:
                continue                  # a line that holds no number
            self.samples.append((t, mhz, w))
            self._first.set()
        self._first.set()

    def __exit__(self, *exc):
        self._proc.terminate()
        self._proc.wait(timeout=30)
        self._thread.join(timeout=30)

    def line(self, windows=None) -> str:
        """Median / min / max SM clock and median / max power of the
        samples inside ``windows`` ((start, end) perf_counter pairs; all
        samples when None)."""
        s = [(mhz, w) for t, mhz, w in self.samples
             if windows is None or any(a <= t <= b for a, b in windows)]
        if not s:
            return "no sample"
        mhz, w = np.array([x[0] for x in s]), np.array([x[1] for x in s])
        return (f"{len(s)} samples: SM clock median {np.median(mhz):.0f} MHz "
                f"(min {mhz.min():.0f}, max {mhz.max():.0f}), power median "
                f"{np.median(w):.1f} W (max {w.max():.1f})")


def sustained(fn, ms: float, seconds: float = 2.0):
    """-> (ms a call over ``seconds`` of calls back to back, CUDA events,
    at ``ms`` a call as a short run measured it; the SM clock and power
    sampled meanwhile, as a line; the number of calls)."""
    reps = max(10, int(seconds * 1e3 / ms))
    fn()
    torch.cuda.synchronize()
    with Clocks() as clocks:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, clocks.line(), reps


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with error {rc}")


def project(lib, h: torch.Tensor, o_host: torch.Tensor, d: int,
            chunk: int = pj.CHUNK):
    """Kernel P of ``lib`` through its interface's wrapper; offsets on the
    host, as project_many passes them. ``chunk``: the work-item size of the
    current interface (None for the first cut's, which has no items)."""
    if not lib.mvs_project_first_cut:
        _build._lib = lib
        pj.CHUNK = chunk
        return pj.project_batch(h, o_host, d, h.device)
    o = o_host.to(h.device)
    out = torch.empty(o.numel() - 1, d, dtype=torch.int32, device=h.device)
    with _build.launch_stream(h.device, lib) as stream:
        rc = lib.mvs_project(h.data_ptr(), o.data_ptr(), o.numel() - 1, d,
                             out.data_ptr(), stream)
    _check(lib, rc, "projection kernel")
    return out


def partials(lib, planes, rc, L, planes_j=None):
    """Kernel X of ``lib`` through its interface's wrapper (the first
    cut's range check reads rc's extremes to the host)."""
    planes_j = planes if planes_j is None else planes_j
    if not lib.mvs_partials_first_cut:
        _build._lib = lib
        flag = pw.range_flag(planes.device)
        return pw.pair_partials(planes, rc, L, planes_j, flag), flag
    ni, nj, d_pad = planes.shape[1], planes_j.shape[1], planes.shape[2]
    n = rc.shape[0]
    out = torch.empty((n, pm.num_planes(L)), dtype=torch.int32,
                      device=planes.device)
    lo_r, hi_r, lo_c, hi_c = torch.stack(
        [*torch.aminmax(rc[:, 0]), *torch.aminmax(rc[:, 1])]).tolist()
    if min(lo_r, lo_c) < 0 or hi_r >= ni or hi_c >= nj:
        raise ValueError("candidate rows/columns out of range")
    with _build.launch_stream(planes.device, lib) as stream:
        err = lib.mvs_partials(planes.data_ptr(), ni * d_pad,
                               planes_j.data_ptr(), nj * d_pad, L, d_pad,
                               rc.data_ptr(), n, out.data_ptr(), stream)
    _check(lib, err, "partials kernel")
    return out, None


def _turns(libs, order, cases):
    """cases: {label: fn(lib)}; -> {name: {label: [ms per turn]}}."""
    runs = {name: {k: [] for k in cases} for name in libs}
    for name in (order + order[::-1]) * 2:
        for label, fn in cases.items():
            runs[name][label].append(fn(libs[name]))
    return runs


def _report(runs, tag):
    card = torch.cuda.get_device_name(0)
    for name, r in runs.items():
        for k, v in r.items():
            vals = [x for x in v if x is not None]
            print(f"[{tag}:{name}] {card}: {k} ms "
                  f"{[round(x, 4) for x in vals]} median "
                  + (f"{np.median(vals):.4f}" if vals else "not measured"),
                  flush=True)


def compare_projection(builds, out_dir, chunks) -> int:
    libs = {name: _load(name, src, out_dir) for name, src in builds}
    shapes = {}
    for label, sizes in (("main", np.full(32768, BASE_HASHES)),
                         ("skewed", skewed_set_sizes())):
        flat, offsets = csr_hashes(sizes, seed=3)
        shapes[label] = (torch.from_numpy(flat).cuda(),
                         torch.from_numpy(offsets))
        print(f"[P] {label}: {len(sizes)} sets, {len(flat)} hashes, sizes "
              f"{int(sizes.min())}..{int(sizes.max())} (median "
              f"{float(np.median(sizes))}), d = 2048", flush=True)
    # (name, chunk): the first cut once, the current interface per chunk
    variants = [(name, None) if lib.mvs_project_first_cut else (name, c)
                for name, lib in libs.items()
                for c in ([None] if lib.mvs_project_first_cut else chunks)]
    for label, (h, o) in shapes.items():
        want = pj.project_batch_plain(h, o.cuda(), 2048)
        for name, c in variants:
            ok = torch.equal(project(libs[name], h, o, 2048, c), want)
            print(f"[P:{name}] {label} chunk {c}: equal to the plain version: "
                  f"{ok}", flush=True)
            if not ok:
                return 3
        del want
    cases = {}
    for label, (h, o) in shapes.items():
        for c in chunks:
            def run(lib, h=h, o=o, c=c):
                return lambda: project(lib, h, o, 2048, c)
            cases[f"{label} chunk {c} wrapper"] = \
                lambda lib, run=run, c=c: None if lib.mvs_project_first_cut \
                and c != chunks[0] else _ms(run(lib))
            cases[f"{label} chunk {c} kernel alone"] = \
                lambda lib, run=run, c=c: None if lib.mvs_project_first_cut \
                and c != chunks[0] else kernel_ms(run(lib), "project_")
    default = pj.CHUNK
    try:
        _report(_turns(libs, [n for n, _ in builds], cases), "P")
    finally:
        pj.CHUNK = default
    return 0


def compare_partials(builds, out_dir) -> int:
    libs = {name: _load(name, src, out_dir) for name, src in builds}
    g = torch.Generator(device="cuda").manual_seed(2)
    L, D, R, B, kc = 2, 2048, 262144, 256, 114
    planes = torch.randint(-128, 128, (3, 4 * 2048, D), generator=g,
                           device="cuda", dtype=torch.int8)
    pairs = torch.randint(0, 4 * 2048, (20762, 2), generator=g,
                          device="cuda", dtype=torch.int32)
    self_rc = torch.arange(4 * 2048, dtype=torch.int32, device="cuda")
    main_rc = torch.cat([pairs, self_rc[:, None].expand(-1, 2)]).contiguous()
    qp = torch.randint(-128, 128, (3, B, D), generator=g, device="cuda",
                       dtype=torch.int8)
    db = torch.randint(-128, 128, (3, R, D), generator=g, device="cuda",
                       dtype=torch.int8)
    rows = torch.arange(B, dtype=torch.int32, device="cuda")[:, None] \
        .expand(B, kc)
    cols = torch.randint(0, R, (B, kc), generator=g, device="cuda",
                         dtype=torch.int32)
    ann_rc = torch.stack([rows, cols], 2).reshape(-1, 2).contiguous()
    shapes = {"main": (planes, main_rc, None), "ann": (qp, ann_rc, db)}
    for label, (x, rc, y) in shapes.items():
        want = pw.pair_partials_plain(x, rc, L, y)
        for name, lib in libs.items():
            got, flag = partials(lib, x, rc, L, y)
            ok = torch.equal(got, want) and (flag is None
                                             or int(flag.item()) == 0)
            print(f"[X:{name}] {label}: {rc.shape[0]} pairs, equal to the "
                  f"plain version: {ok}", flush=True)
            if not ok:
                return 3
    cases = {}
    for label, (x, rc, y) in shapes.items():
        cases[f"{label} wrapper"] = lambda lib, x=x, rc=rc, y=y: cold_ms(
            lambda: partials(lib, x, rc, L, y))
        cases[f"{label} kernel alone"] = \
            lambda lib, x=x, rc=rc, y=y: kernel_ms(
                lambda: partials(lib, x, rc, L, y), "partials_kernel",
                cold=True)
    _report(_turns(libs, [n for n, _ in builds], cases), "X")
    return 0


def compare_sweep(builds, out_dir) -> int:
    libs = {name: _load(name, src, out_dir) for name, src in builds}
    g = torch.Generator(device="cuda").manual_seed(1)
    D, R = 2048, 262144
    db = torch.randint(-64, 64, (3, R, D), generator=g, device="cuda",
                       dtype=torch.int8)
    qp = torch.randint(-64, 64, (3, 256, D), generator=g, device="cuda",
                       dtype=torch.int8)
    inv = torch.rand(R, generator=g, device="cuda")
    A = (torch.rand((8192, 16384), generator=g, device="cuda") < 1 / 128) \
        .to(torch.int8)
    C = torch.zeros((8192, 8192), dtype=torch.int32, device="cuda")
    want_q = pw.scan_scores_plain(qp, db, inv, R - 77)
    want_g = mh.gram_accumulate_plain(torch.zeros_like(C), A)
    for name, lib in libs.items():
        _build._lib = lib
        ok = torch.equal(pw.scan_scores(qp, db, inv, R - 77), want_q)
        ok = ok and torch.equal(mh.mirror_upper(mh.gram_accumulate(
            torch.zeros_like(C), A)), want_g)
        print(f"[{name}] S SCORE and G equal to the plain versions: {ok}",
              flush=True)
        if not ok:
            return 3
    del want_q, want_g

    def use(lib, fn):
        _build._lib = lib
        return _ms(fn)

    cases = {
        "SCORE": lambda lib: use(lib, lambda: pw.scan_scores(
            qp, db, inv, R - 77)),
        "G": lambda lib: use(lib, lambda: mh.gram_accumulate(C, A)),
    }
    _report(_turns(libs, [n for n, _ in builds], cases), "S/G")
    return 0


# one turn of --shards: the fused, then the two-phase shard of a db, in
# the process of one tree
_SHARD_TURN = """
import json, re, sys, time
from torch.profiler import ProfilerActivity, profile
from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
from metagenome_vector_sketches_tpu_torch.parallel.engine import MeshSweepOps
db, out = sys.argv[1], sys.argv[2]
windows = {}
def timed(name):
    real = getattr(MeshSweepOps, name)
    def call(*args, **kw):
        t0 = time.perf_counter()
        res = real(*args, **kw)
        windows.setdefault(name, []).append((t0, time.perf_counter()))
        return res
    setattr(MeshSweepOps, name, call)
for name in ("sweep_counts", "sweep_extract_fused"):
    timed(name)
for engine in ("fused", "two_phase"):
    windows.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mc.compute_pairwise_shard(db, out + "_" + engine, device="cuda",
                                  verbose=False, engine=engine)
        wall = time.perf_counter() - t0
    st = {k: mc.LAST_STAGES.get(k) for k in (
        "stage_ms", "sweep_ms", "extract_ms", "finalize_ms", "write_ms",
        "candidates", "pairs_written", "hot_tiles", "reruns")}
    device_ms = {}
    for e in prof.key_averages():
        m = re.search(r"\\w+_kernel(<[^>]*>)?", e.key)
        t = getattr(e, "self_device_time_total", 0) / 1e3
        if m and t:
            device_ms[m.group(0)] = device_ms.get(m.group(0), 0) + t
    print(json.dumps({"engine": engine, "wall_s": wall, **st,
                      "device_ms": device_ms, "module": mc.__file__,
                      "windows": windows}), flush=True)
"""


def compare_shards(builds, n: int) -> int:
    import filecmp
    import shutil
    from .bench_data import synth_hashes_file
    from .io.ingest import sketch
    work = tempfile.mkdtemp(prefix="compare_shards_", dir=os.getcwd())
    try:
        hashes, db = os.path.join(work, "h.txt"), os.path.join(work, "db")
        synth_hashes_file(hashes, n, max(1, n // 64), max(1, n // 128))
        sketch(hashes, db, 2048, device="cuda", verbose=False)
        torch.cuda.empty_cache()

        def turn(name, tree, out):
            # run from the tree: "python -c" puts its working directory
            # first on sys.path, ahead of PYTHONPATH
            tree = os.path.abspath(tree)
            with Clocks() as clocks:
                r = subprocess.run(
                    [sys.executable, "-c", _SHARD_TURN, db, out],
                    capture_output=True, text=True, cwd=tree,
                    env=dict(os.environ, PYTHONPATH=tree))
            if r.returncode:
                raise RuntimeError(f"{name}: shard turn failed\n{r.stderr}")
            runs = [json.loads(x) for x in r.stdout.splitlines()
                    if x.startswith("{")]
            for st in runs:
                if not st.pop("module").startswith(tree + os.sep):
                    raise RuntimeError(f"{name}: the turn did not run {tree}")
                # the turn's sweep windows (perf_counter is system-wide)
                st["clocks"] = {k: clocks.line(w) for k, w in
                                st.pop("windows").items()}
            return runs

        for name, tree in builds:         # each tree builds its library
            turn(name, tree, os.path.join(work, f"warm_{name}"))
        card = torch.cuda.get_device_name(0)
        ref = None
        order = [name for name, _ in builds]
        trees = dict(builds)
        for i, name in enumerate((order + order[::-1]) * 2):
            out = os.path.join(work, f"{name}_{i}")
            for st in turn(name, trees[name], out):
                print(f"[shards:{name}] {card}: N={n} turn {i} "
                      f"{json.dumps(st)}", flush=True)
            for engine in ("fused", "two_phase"):
                folder = os.path.join(f"{out}_{engine}", "shard_0")
                ref = ref or folder
                same = all(filecmp.cmp(os.path.join(ref, f),
                                       os.path.join(folder, f),
                                       shallow=False)
                           for f in ("matrix.bin", "row_index.bin",
                                     "neighbor_start.bin"))
                if not same:
                    print(f"[shards:{name}] {engine} shard differs from "
                          f"the first", flush=True)
                    return 3
                if folder != ref:
                    shutil.rmtree(f"{out}_{engine}")
        print(f"[shards] every shard byte-equal to the first", flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def append_parent(lib, planes, thr, coords, tile: int, cap: int, d: int):
    """Kernel S APPEND of a build of the sweep.cu from before APPEND moved
    to count.cu (``mvs_sweep``; ``lib`` its CDLL, or its _WithCount), called
    as that parent's launch_sweep called it: the coordinates copied to the
    card on every call, self-pairs masked -> (rc, counts, total)."""
    P, n, d_pad = planes.shape
    dev = planes.device
    coords = np.ascontiguousarray(coords, dtype=np.int32).reshape(-1, 2)
    counts = torch.zeros(len(coords), dtype=torch.int32, device=dev)
    rc = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    total = torch.zeros(1, dtype=torch.int32, device=dev)
    coords_dev = torch.from_numpy(coords).to(dev)
    w = pm.plane_weights(pm.limbs_from_planes(P))
    with _build.launch_stream(dev, lib) as stream:
        err = lib.mvs_sweep(
            planes.data_ptr(), planes.data_ptr(), thr.data_ptr(),
            thr.data_ptr(), P, d, d_pad, n * d_pad, n * d_pad,
            coords_dev.data_ptr(), len(coords), tile, tile,
            w.ctypes.data_as(ctypes.c_void_p), float(pm.SLACK_REL),
            float(pm.SLACK_ABS), 1, 0, counts.data_ptr(), rc.data_ptr(),
            total.data_ptr(), cap, stream)
    _check(lib, err, "sweep kernel (APPEND)")
    return rc, counts, total


def _append_call(lib, planes, thr, tiles, tile, cap, d):
    """Kernel APPEND of one build over the TileList ``tiles``, self-pairs
    masked (a count.cu build), or the parent's APPEND epilogue."""
    if hasattr(lib, "mvs_sweep"):
        return append_parent(lib, planes, thr, tiles.host, tile, cap, d)
    _build._lib = lib
    return pw.sweep_extract(planes, thr, planes, thr, tiles, tile, cap, True,
                            d)


def _yardstick(planes, coords, tile: int) -> float:
    """ms of one torch._int_mm per plane and tile on the planes' (tile x
    tile) blocks: the GEMM core alone, a yardstick, not a kernel of the
    port."""
    P, nt = planes.shape[0], planes.shape[1] // tile
    blocks = [planes[p, i * tile:(i + 1) * tile] for p in range(P)
              for i in range(nt)]
    return _ms(lambda: [torch._int_mm(blocks[p * nt + r],
                                      blocks[p * nt + c].t())
                        for p in range(P) for r, c in coords.tolist()],
               reps=5)


def _sorted_rows(rc, n: int) -> np.ndarray:
    a = rc[:n].cpu().numpy().astype(np.int64)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


def compare_append(builds, out_dir) -> int:
    libs = {name: _load(name, src, out_dir) for name, src in builds}
    g = torch.Generator(device="cuda").manual_seed(3)
    D, tile, nt, cap = 2048, 2048, 4, 1 << 22
    card = torch.cuda.get_device_name(0)
    tiles = pw.TileList([(r, c) for r in range(nt) for c in range(r, nt)],
                        "cuda")
    shapes = {}
    for P in (3, 6):
        planes, thr = count_state(P, g, nt, tile, D)
        t0 = time.perf_counter()
        want = pw.sweep_extract_plain(planes, thr, planes, thr, tiles.host,
                                      tile, cap, True, D)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        bound = 2 * P * len(tiles) * tile * tile * D / 1979e12 * 1e3
        yard = _yardstick(planes, tiles.host, tile)
        print(f"[APPEND] {card}: P={P}: {len(tiles)} tiles of {tile}^2 (the "
              f"triangle of {nt} x {nt}, self-pairs masked), d={D}, "
              f"{int(want[2].item())} survivors; bound {bound:.4f} ms "
              f"(operations at 1,979 TOP/s); plain {plain:.1f} ms; "
              f"yardstick, not a kernel of the port: {P} x {len(tiles)} "
              f"torch._int_mm {tile}^3 {yard:.4f} ms", flush=True)
        shapes[P] = (planes, thr, want)
    # the fused engine's first round at N = 262,144: the first 511 tiles
    # of the 128 x 128 triangle, one launch (phase 2-like rows, P = 3)
    planes, thr = count_state(3, g, 128, tile, D)
    big = pw.TileList([(r, c) for r in range(128) for c in range(r, 128)]
                      [:(2**31 - 1) // (tile * tile)], "cuda")
    want = pw.sweep_extract_plain(planes, thr, planes, thr, big.host, tile,
                                  cap, True, D)
    shapes["round"] = (planes, thr, want)
    print(f"[APPEND] {card}: round: {len(big)} tiles of {tile}^2 of a "
          f"262,144-row triangle, P=3, {int(want[2].item())} survivors; "
          f"bound {2 * 3 * len(big) * tile * tile * D / 1979e12 * 1e3:.3f} "
          f"ms", flush=True)
    lists = {3: tiles, 6: tiles, "round": big}
    for name, lib in libs.items():
        for P, (planes, thr, want) in shapes.items():
            got = _append_call(lib, planes, thr, lists[P], tile, cap, D)
            n = int(want[2].item())
            ok = (int(got[2].item()) == n and torch.equal(got[1], want[1])
                  and np.array_equal(_sorted_rows(got[0], n),
                                     _sorted_rows(want[0], n)))
            print(f"[APPEND:{name}] P={P}: survivors, counts and total equal "
                  f"to the plain version: {ok}", flush=True)
            if not ok:
                return 3
    cases = {}
    for P, (planes, thr, _) in shapes.items():
        def run(lib, planes=planes, thr=thr, tl=lists[P]):
            return lambda: _append_call(lib, planes, thr, tl, tile, cap, D)

        def back_to_back(lib, run=run, P=P):
            ms, line, reps = sustained(run(lib), _ms(run(lib), reps=3))
            print(f"[APPEND:{lib.name}] P={P}: {reps} calls back to back: "
                  f"{line}", flush=True)
            return ms
        if P == "round":
            cases["round one call"] = lambda lib, run=run: _ms(run(lib),
                                                               reps=1)
        else:
            cases[f"P={P} wrapper"] = lambda lib, run=run: _ms(run(lib))
            cases[f"P={P} kernel alone"] = lambda lib, run=run: kernel_ms(
                run(lib), kernel_name(lib))
            cases[f"P={P} host of a call"] = lambda lib, run=run: host_ms(
                run(lib))
        cases[f"P={P} 2 s back to back"] = back_to_back
    for name, lib in libs.items():
        lib.name = name
    _report(_turns(libs, [n for n, _ in builds], cases), "APPEND")
    return 0


def count_parent(lib, planes, thr, coords, tile: int, d: int):
    """Kernel S COUNT of a build of the sweep.cu before kernel COUNT
    (``lib``: its _WithCount), called as that parent's count_tiles called
    it: the tiles expanded on the host into the JAX engine's sub-blocks,
    the coordinates copied to the card, one launch with append = 0, the
    sub-block counts summed to the tile."""
    P, n, d_pad = planes.shape
    bi, bj = pp.engine_blocks(P, tile, planes.device)
    mi, mj = tile // bi, tile // bj
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    rows = coords[:, 0, None, None] * mi + np.arange(mi)[None, :, None]
    cols = coords[:, 1, None, None] * mj + np.arange(mj)[None, None, :]
    sub = np.stack(np.broadcast_arrays(rows, cols), axis=-1).reshape(-1, 2)
    sub_dev = torch.from_numpy(sub.astype(np.int32)).to(planes.device)
    counts = torch.zeros(len(sub), dtype=torch.int32, device=planes.device)
    w = pm.plane_weights(pm.limbs_from_planes(P))
    with _build.launch_stream(planes.device, lib) as stream:
        err = lib.raw.mvs_sweep(
            planes.data_ptr(), planes.data_ptr(), thr.data_ptr(),
            thr.data_ptr(), P, d, d_pad, n * d_pad, n * d_pad,
            sub_dev.data_ptr(), len(sub), bi, bj,
            w.ctypes.data_as(ctypes.c_void_p), float(pm.SLACK_REL),
            float(pm.SLACK_ABS), 0, 0, 0, counts.data_ptr(), None, None, 0,
            stream)
    _check(lib, err, "sweep kernel (COUNT)")
    return counts.reshape(len(coords), mi * mj).sum(dim=1, dtype=torch.int32)


def _count_call(lib, planes, thr, tiles, tile, d):
    """The counts sweep of one build: kernel COUNT over the TileList
    ``tiles`` (a count.cu build), or the parent's COUNT epilogue."""
    if isinstance(lib, _WithCount):
        return count_parent(lib, planes, thr, tiles.host, tile, d)
    _build._lib = lib
    return pp.count_tiles(planes, thr, planes, thr, tiles, tile, d)


def host_ms(fn, reps: int = 50) -> float:
    """Median host time of one fn() call, each started on an idle device:
    the wrapper's own work up to its launch, the kernel left to run."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def count_state(P: int, g, nt: int = 4, tile: int = 2048, d: int = 2048):
    """(planes, thr) of nt x tile rows at d on the card: P = 3 (L = 2,
    |v| <= 600) or P = 6 (L = 3, an int16-like db, |v| <= 30,000), normal
    random vectors with rows 1-4 copies of row 0."""
    m = {3: 600, 6: 30000}[P]
    L = pm.pick_limbs(m)
    V = (torch.randn((nt * tile, d), generator=g, device="cuda") * m / 4) \
        .round_().clamp_(-m, m).to(torch.int32)
    V[1:5] = V[0]
    planes = torch.zeros((P, nt * tile, pw.pad_dim(d)), dtype=torch.int8,
                         device="cuda")
    pw.planes_update(planes, pw.decompose_limbs(V, L), 0)
    thr = ((V.double() ** 2).sum(1) / d + pm.threshold_adjust(L, m, d)) \
        .float().contiguous()
    return planes, thr


def compare_count(builds, out_dir) -> int:
    libs = {name: _load(name, src, out_dir) for name, src in builds}
    g = torch.Generator(device="cuda").manual_seed(3)
    D, tile, nt = 2048, 2048, 4
    card = torch.cuda.get_device_name(0)
    tiles = pp.TileList([(r, c) for r in range(nt) for c in range(nt)],
                        "cuda")
    shapes = {}
    for P in (3, 6):
        planes, thr = count_state(P, g, nt, tile, D)
        t0 = time.perf_counter()
        want = pp.count_tiles_plain(planes, thr, planes, thr, tiles.host,
                                    tile, D)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        yard = _yardstick(planes, tiles.host, tile)
        bound = 2 * P * len(tiles) * tile * tile * D / 1979e12 * 1e3
        print(f"[COUNT] {card}: P={P}: {len(tiles)} tiles of {tile}^2, "
              f"d={D}, {int(want.sum())} survivors; bound {bound:.4f} ms "
              f"(operations at 1,979 TOP/s); plain {plain:.1f} ms; "
              f"yardstick, not a kernel of the port: {P} x {len(tiles)} "
              f"torch._int_mm {tile}^3 {yard:.4f} ms", flush=True)
        shapes[P] = (planes, thr, want)
    for name, lib in libs.items():
        for P, (planes, thr, want) in shapes.items():
            ok = torch.equal(_count_call(lib, planes, thr, tiles, tile, D),
                             want)
            print(f"[COUNT:{name}] P={P}: equal to the plain version: {ok}",
                  flush=True)
            if not ok:
                return 3
    cases = {}
    for P, (planes, thr, _) in shapes.items():
        def run(lib, planes=planes, thr=thr):
            return lambda: _count_call(lib, planes, thr, tiles, tile, D)
        cases[f"P={P} wrapper"] = lambda lib, run=run: _ms(run(lib))
        cases[f"P={P} kernel alone"] = lambda lib, run=run: kernel_ms(
            run(lib), kernel_name(lib))
        cases[f"P={P} host of a call"] = lambda lib, run=run: host_ms(
            run(lib))
    _report(_turns(libs, [n for n, _ in builds], cases), "COUNT")
    return 0


def select_first_cut(lib, scores, base, valid, none, kc, best, pool):
    """Kernel K of ``lib`` through the first cut's interface (``mvs_select``
    with 20 parameters: a block-maximum kernel and a row kernel, each
    scratch buffer a tensor of its own) -> select_chunk's outputs."""
    from .ann import select as sel
    B, W = scores.shape
    dev = scores.device
    i64 = dict(dtype=torch.int64, device=dev)
    w0 = best.shape[1]
    wm = min(pool, w0 + kc)
    out_key, out_lane = (torch.empty((B, kc), **i64) for _ in range(2))
    m_key, m_pos = (torch.empty((B, wm), **i64) for _ in range(2))
    nb = -(-W // sel.BLOCK)
    bm = torch.empty((B, nb), **i64) if kc < nb and kc <= sel.SMALL_K \
        else None
    big = kc > sel.SMALL_K
    sk = torch.empty((B, 2, kc), **i64) if big else None
    sl = torch.empty((B, 2, kc), dtype=torch.int32, device=dev) if big \
        else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _build.launch_stream(dev, lib) as stream:
        err = lib.mvs_select(
            scores.data_ptr(), None, scores.stride(0), B, W, base,
            max(0, min(valid, W)), none, kc, ptr(bm), ptr(sk), ptr(sl),
            out_key.data_ptr(), out_lane.data_ptr(), best.data_ptr(), w0,
            wm, ptr(m_key) if wm else None, ptr(m_pos) if wm else None,
            stream)
    _check(lib, err, "select kernel")
    return out_key, out_lane, m_key, m_pos


def _select(lib, args):
    if lib.mvs_select_first_cut:
        return select_first_cut(lib, *args)
    from .ann import select as sel
    _build._lib = lib
    return sel.select_chunk(*args)


# kernel K's shapes at phase 4's size (B x R = 256 x 262,144 scores): the
# int8 search's pool (pool_for(50) = 114), the f32 search's (k = 50),
# the adaptive search's level 4 (k = 50 * 3^4: pool_for = 4,556) and its
# deepest level (kc = R)
SELECT_SHAPES = (("int8", 114), ("f32", 50), ("level 4", 4556),
                 ("kc = R", 262144))


def compare_select(builds, out_dir) -> int:
    from .ann import select as sel
    libs = {name: _load(name, src, out_dir) for name, src in builds}
    g = torch.Generator(device="cuda").manual_seed(4)
    B, R, n = 256, 262144, 1 << 20
    scores = [torch.randn((B, R), generator=g, device="cuda")
              for _ in range(2)]
    empty = torch.empty((B, 0), dtype=torch.int64, device="cuda")
    shapes = {}
    for label, kc in SELECT_SHAPES:
        best = empty if kc == R else \
            sel.select_chunk_plain(scores[1], R, R, n, kc, empty, kc)[2]
        args = (scores[0], 0, R - 77, n, kc, best, kc)
        shapes[label] = (args, sel.select_chunk_plain(*args))
    for name, lib in libs.items():
        for label, (args, want) in shapes.items():
            ok = all(torch.equal(a, b) for a, b in
                     zip(_select(lib, args), want))
            print(f"[K:{name}] {label}: {B} x {R} scores, kc = "
                  f"{args[4]}, W0 = {args[5].shape[1]}: equal to the plain "
                  f"version: {ok}", flush=True)
            if not ok:
                return 3
    # yardsticks (not kernels of the port): one PyTorch call over the
    # packed keys that computes K's selection, the stable sort of the whole
    # row for any kc and torch.topk (unstable among equal keys) for this kc
    card = torch.cuda.get_device_name(0)
    lane = torch.arange(R, device="cuda")
    keys = sel.rank_keys(scores[0], torch.where(lane < R - 77, lane, n))
    sort_ms = _ms(lambda: torch.sort(keys, dim=1, descending=True,
                                     stable=True), reps=5)
    print(f"[K:yardstick] {card}: torch.sort over the packed {B} x {R} "
          f"keys (stable, descending) {sort_ms:.4f} ms", flush=True)
    for label, kc in SELECT_SHAPES:
        top_ms = _ms(lambda: torch.topk(keys, kc, dim=1), reps=5)
        print(f"[K:yardstick] {card}: {label}: torch.topk(keys, {kc}) "
              f"{top_ms:.4f} ms", flush=True)
    del keys

    def wrapper(lib, args):
        return _ms(lambda: _select(lib, args),
                   reps=3 if args[4] > sel.SMALL_K else 20)

    def alone(lib, args):
        times = kernel_times(lambda: _select(lib, args), "select_",
                             reps=3 if args[4] > sel.SMALL_K else 10)
        for k, ms in sorted(times.items()):
            print(f"[K:{lib.name}]   {args[4]}: {k[:90]} {ms:.4f} ms")
        return sum(times.values()) if times else None

    def enqueue(lib, args, reps=50):
        # host time of a call (the launch queue stays far from full)
        _select(lib, args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            _select(lib, args)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    cases = {"int8 host enqueue": lambda lib: enqueue(lib, shapes["int8"][0])}
    for label, (args, _) in shapes.items():
        cases[f"{label} wrapper"] = \
            lambda lib, args=args: wrapper(lib, args)
        cases[f"{label} kernel alone"] = \
            lambda lib, args=args: alone(lib, args)
    for name, lib in libs.items():
        lib.name = name
    _report(_turns(libs, [n for n, _ in builds], cases), "K")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sweep", nargs="*", metavar="name=sweep.cu")
    ap.add_argument("--projection", nargs="+", default=[],
                    metavar="name=projection.cu")
    ap.add_argument("--partials", nargs="+", default=[],
                    metavar="name=partials.cu")
    ap.add_argument("--select", nargs="+", default=[],
                    metavar="name=select.cu")
    ap.add_argument("--append", nargs="+", default=[],
                    metavar="name=count.cu|sweep.cu")
    ap.add_argument("--count", nargs="+", default=[],
                    metavar="name=count.cu|sweep.cu")
    ap.add_argument("--shards", nargs="+", default=[],
                    metavar="name=TREE")
    ap.add_argument("--n", type=int, default=262144,
                    help="rows of --shards' db (default 262,144)")
    ap.add_argument("--chunks", default=str(pj.CHUNK),
                    help="kernel P work-item sizes to time, comma-separated "
                         f"(default {pj.CHUNK}; a first-cut build has none)")
    ap.add_argument("--sass", metavar="DIR",
                    help="write each build's cuobjdump -sass text into DIR "
                         "and print its kernels' innermost loops")
    args = ap.parse_args(argv)
    global _SASS_DIR
    _SASS_DIR = args.sass
    if _SASS_DIR:
        os.makedirs(_SASS_DIR, exist_ok=True)
    chunks = [int(c) for c in args.chunks.split(",")]
    groups = [(compare_sweep, args.sweep),
              (lambda b, o: compare_projection(b, o, chunks), args.projection),
              (compare_partials, args.partials),
              (compare_select, args.select),
              (compare_append, args.append),
              (compare_count, args.count),
              (lambda b, o: compare_shards(b, args.n), args.shards)]
    if not any(b for _, b in groups):
        ap.error("no builds given")
    for _, builds in groups:
        if any("=" not in b for b in builds):
            ap.error("every build is name=path")
    if not torch.cuda.is_available():
        print("compare_kernels: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    out_dir = tempfile.mkdtemp(prefix="compare_kernels_")
    for fn, builds in groups:
        if builds:
            rc = fn([b.split("=", 1) for b in builds], out_dir)
            if rc:
                return rc
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
