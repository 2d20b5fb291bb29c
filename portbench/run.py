"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run makes the cell's inputs from the seed,
warms the program (``metagenome_vector_sketches_tpu_torch``) up, drives the
cell's traffic for ``--seconds``, judges what the window produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read from a profiler
trace of the window), ``device`` and, traced, ``breakdown``; last,
``checks``: each number compared with its limit (also the last lines on
standard error).

It exits non-zero and prints no result when CUDA is missing or has fewer
devices than the cell asks for, and when the process has loaded JAX or the
JAX package by the time the window has closed. Work files go under
``$TMPDIR`` and are removed at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "metagenome_vector_sketches_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a metric's reader reads: the window's calls (each with the
    benchmark's span, the program's stage record and the call's size),
    the window's and the set-up's seconds, the db's sizes and the trace."""

    def __init__(self, calls, window_s, setup_s, db, trace):
        self.calls, self.window_s, self.setup_s = calls, window_s, setup_s
        self.db, self.trace = db, trace


def _power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def window(driver, seconds: float) -> tuple[list, int, float]:
    """Drive ``driver`` for ``seconds``: -> (the calls' records, calls that
    raised, the window's wall seconds, up to the last call's return). A
    call is started while its due time (an open loop's schedule; a closed
    loop's, None, is now) lies inside the window; a call that raises ends
    the window."""
    calls, failed = [], 0
    t0 = time.perf_counter()
    while True:
        due = driver.due(len(calls), t0)
        if (time.perf_counter() if due is None else due) - t0 >= seconds:
            break
        try:
            calls.append(driver.call(len(calls), due))
        except Exception:  # a failed call ends the window
            traceback.print_exc()
            failed += 1
            break
    return calls, failed, time.perf_counter() - t0


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = T_START,
             root: str | None = None, base: str | None = None) -> dict:
    """One run of ``workload``; -> the result line's object (its
    ``checks`` last) plus ``"forbidden"``, the forbidden modules loaded by
    the end of the run, the check included."""
    import torch

    from . import spec
    from .trace import traced
    root = root or spec.ROOT
    base = base or spec.HERE
    w = spec.cell(bench, workload)
    cfg = spec.config(bench, w["config"], root)
    tr = spec.traffic(w["traffic"], base)
    work = os.path.join(tempfile.gettempdir(), f"portbench-{workload}")
    shutil.rmtree(work, ignore_errors=True)
    cuda = torch.device(device).type == "cuda"
    try:
        make = spec.driver(tr["driver"], base)
        driver = make(cfg, tr, seed, work, device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        with traced(work, trace) as held:
            calls, failed, window_s = window(driver, seconds)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        for i, c in enumerate(calls):
            print(f"call {i} {c['kind']} {c.get('k', c.get('f'))} "
                  f"{c['span_ms']:.1f} ms", file=sys.stderr)
        ctx = Context(calls, window_s, setup_s, driver.meta, held.trace)
        metrics = {}
        for m in spec.metrics_of(bench, workload, trace):
            v = spec.reader(m["name"], base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        driver.free()
        checks = driver.check(calls) if calls else {}
        correct = (failed == 0 and bool(calls)
                   and all(v <= lim for v, lim in checks.values()))
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": int(w["chips"]), "memory_peak_bytes": int(peak)}
        if cuda:
            dev["power_limit_w"] = _power_limit()
        out = {"correct": correct, "attempted": len(calls) + failed,
               "failed": failed, "metrics": metrics, "device": dev}
        if held.trace is not None:
            dev["busy_s"] = held.trace.busy_s
            dev["window_s"] = held.trace.window_s
            out["breakdown"] = {"device_ops": held.trace.device_ops(),
                                "idle_gaps": held.trace.idle_gaps()}
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()}
        # last: whatever the window, the readers or the check loaded
        out["forbidden"] = forbidden_modules()
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from . import spec
    bench = spec.load_benchmark()
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    res = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    found = res.pop("forbidden")
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
