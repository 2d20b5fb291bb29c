"""The control of a cell's correctness check: the window's outputs judged
against the plain reference computed in each lower precision, beside the
readings of the exact reference, on several seeds in one process.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        --seconds 8 --precisions float32,int8

prints one JSON line a seed: {"seed", "attempted", "readings": {precision:
{number: value}}}. The benchmark's own runs do not run it; the limits of
the check are set from its readings (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile


def readings(bench: dict, workload: str, seed: int, seconds: float,
             precisions: list, device: str = "cuda", root=None,
             base=None) -> dict:
    from . import run, spec
    root, base = root or spec.ROOT, base or spec.HERE
    w = spec.cell(bench, workload)
    cfg = spec.config(bench, w["config"], root)
    tr = spec.traffic(w["traffic"], base)
    work = os.path.join(tempfile.gettempdir(), f"portbench-control-{workload}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        make = spec.driver(tr["driver"], base)
        driver = make(cfg, tr, seed, work, device)
        calls, failed, _ = run.window(driver, seconds)
        if failed:
            raise RuntimeError(f"a call of the program failed (seed {seed})")
        driver.free()
        out = {}
        for p in ["exact"] + list(precisions):
            out[p] = {k: v for k, (v, _) in driver.check(calls, p).items()}
        return {"seed": seed, "attempted": len(calls), "readings": out}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--precisions", default="float32,int16,int8")
    args = ap.parse_args(argv)
    import torch

    from . import spec
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    for s in args.seeds.split(","):
        print(json.dumps(readings(bench, args.workload, int(s), args.seconds,
                                  args.precisions.split(","))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
