"""Where the time of an ANN search goes, on one NVIDIA GPU.

    python -m metagenome_vector_sketches_tpu_torch.search_split [--n N]

Builds ``chip_smoke.py`` phase 4's index (N = 1,048,576 x d = 2048 int32
sketch-like vectors made on the card from seed 5: rounded normals of sd 150
clipped to +-600, L = 2, P = 3, rows 1-3 of every 256 near-duplicates of
row 0), its int8-plane engine in chunks of 262,144 rows and its f32 engine
from the L2-normalised copy, and queries B = 256 planted rows at k = 50.
Then, for each engine: one first search (timed: the process's first on
the index), ``--reps`` timed searches (host
wall around a call that returns host arrays; the engine's
``LAST_SEARCH_STAGES`` after each), and one search inside
``utils.profiling.device_trace`` whose kernels are summed by name (device
ms and launches; the Chrome trace lands under ``--trace-dir``).

The script imports only APIs that every tree of the port since its
multi-device layer has, with absolute imports, so a copy of it can time
another tree of the package: ``PYTHONPATH=<tree> python <copy of this
file>``. The last line of stdout is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

D = 2048
CHUNK = 262144
B, K = 256, 50
STRIDE = 256            # a planted group of 4 starts every 256 rows


def make_chunks(n: int, seed: int = 5):
    """[(base, (rows, D) int32)] on the card: chip_smoke.py's _ann_chunks."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    chunks = []
    for s in range(0, n, CHUNK):
        rows = min(CHUNK, n - s)
        v = (torch.randn((rows, D), generator=g, device="cuda") * 150) \
            .round_().clamp_(-600, 600).to(torch.int32)
        grp = v[:rows // STRIDE * STRIDE].view(-1, STRIDE, D)
        noise = torch.randint(-3, 4, (grp.shape[0], 3, D), generator=g,
                              device="cuda", dtype=torch.int32)
        grp[:, 1:4] = (grp[:, :1] + noise).clamp_(-600, 600)
        chunks.append((s, v))
    return chunks


def kernel_table(prof) -> list:
    """[(kernel name, device ms, launches)] of the CUDA kernels in a
    profile, largest first (kernel rows only: op rows would count the same
    device time twice)."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def timed_search(name, fn, stages, reps, trace_dir):
    """-> {first_ms, walls_ms, stages, trace: {wall_ms, kernels,
    device_ms}}."""
    from metagenome_vector_sketches_tpu_torch.utils.profiling import (
        device_trace)
    t0 = time.perf_counter()
    fn()
    first = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    walls, st = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
        st.append(dict(stages) if stages is not None else None)
    torch.cuda.synchronize()
    with device_trace(trace_dir) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    table = kernel_table(prof)
    busy = sum(ms for _, ms, _ in table)
    print(f"[{name}] first call {first:.3f} ms; walls (ms) "
          f"{[round(w, 3) for w in walls]}", flush=True)
    for s in st:
        print(f"[{name}] stages {json.dumps(s)}", flush=True)
    print(f"[{name}] traced call: wall {wall:.3f} ms, kernels busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the wall)", flush=True)
    for kname, ms, n in table[:14]:
        print(f"[{name}]   {ms:9.4f} ms  x{n:<5d} {kname[:110]}", flush=True)
    return {"first_ms": first, "walls_ms": walls, "stages": st,
            "trace": {"wall_ms": wall, "device_ms": busy,
                      "kernels": [[k[:160], ms, n] for k, ms, n in table]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace-dir", default="build/search_split")
    ap.add_argument("--tag", default="", help="a label printed in the JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("search_split: needs an NVIDIA GPU")
    import metagenome_vector_sketches_tpu_torch as pkg
    from metagenome_vector_sketches_tpu_torch.ann import flat_index as fi
    from metagenome_vector_sketches_tpu_torch.ann import int_index as ii
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"{card}; package {pkg.__file__}", flush=True)
    chunks = make_chunks(args.n)
    flat_chunks = []
    for s, v in chunks:
        x = v.float()
        flat_chunks.append((s, x / x.norm(dim=1, keepdim=True).clamp_(
            min=1e-30)))
        del x
    rng = np.random.default_rng(9)
    rows = np.sort(rng.choice(args.n // STRIDE, B, replace=False)) * STRIDE
    V_q = torch.cat([chunks[r // CHUNK][1][r % CHUNK][None]
                     for r in rows.tolist()]).cpu().numpy()
    Qn = fi.normalize_l2(V_q.astype(np.float32))
    index = ii.IntExactIndex.from_device_chunks(list(chunks), D)
    flat = fi.FlatIPIndex.from_device_chunks(flat_chunks, D)
    del chunks
    torch.cuda.synchronize()
    out = {"tag": args.tag, "card": card, "n": args.n, "B": B, "k": K}
    out["int8"] = timed_search("int8", lambda: index.search(V_q, K),
                               ii.LAST_SEARCH_STAGES, args.reps,
                               args.trace_dir)
    out["f32"] = timed_search("f32", lambda: flat.search(Qn, K),
                              getattr(fi, "LAST_SEARCH_STAGES", None),
                              args.reps, args.trace_dir)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
