"""Finding a cell's parts by name: the cell in BENCHMARK.json, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the driver that the traffic names
(``drivers/<name>.py``, a class ``Driver``) and the reader of each metric
(``metrics/<name>.py``, a function ``read(ctx)`` that returns a number, or
None when the run gave it nothing to read). A new cell, configuration,
traffic mix, driver or metric is a new file and a new entry; no code names
them.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, base: str = HERE) -> dict:
    with open(os.path.join(base, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _load(kind: str, name: str, base: str):
    path = os.path.join(base, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, base: str = HERE):
    """The ``Driver`` class of driver ``name``: ``Driver(cfg, traffic,
    seed, work, device)`` makes the inputs and warms up; ``due``, ``call``,
    ``free``, ``check`` and ``meta`` serve the window (``run.window``)."""
    return _load("drivers", name, base).Driver


def reader(name: str, base: str = HERE):
    """The ``read(ctx)`` function of metric ``name``."""
    return _load("metrics", name, base).read
