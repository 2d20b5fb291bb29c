"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a tiny
size (N = 2,000, d = 256, small tiles and query files), whose configuration,
traffic, driver and metric files live in a temporary folder, and a card fixture
that skips where CUDA is not available."""

from __future__ import annotations

import copy
import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)


def shrink(bench: dict, base: str) -> dict:
    """Write tiny copies of the benchmark's configurations and traffic into
    ``base`` (with the drivers and the metric readers) -> the BENCHMARK.json
    dict that names them (configuration files by absolute path)."""
    bench = copy.deepcopy(bench)
    for sub in ("configs", "traffic"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for sub in ("metrics", "drivers"):
        shutil.copytree(os.path.join(PKG, sub), os.path.join(base, sub),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(num_vectors=2000, dimension=256)
        c["file"] = os.path.join(base, "configs", f"{c['name']}.json")
        with open(c["file"], "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(PKG, "traffic")):
        with open(os.path.join(PKG, "traffic", name)) as f:
            tr = json.load(f)
        if tr["driver"] == "shard_job":
            tr.update(check_rows_per_shard=64)
            tr["program_args"]["tile_rows"] = 256
        else:
            tr.update(files=2, queries_per_file=8, rate_per_s=50.0)
            tr["relatives"]["clusters"] = [60]
        with open(os.path.join(base, "traffic", name), "w") as f:
            json.dump(tr, f)
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """-> (BENCHMARK.json dict at the tiny size, the folder of its files)."""
    from portbench import spec
    base = str(tmp_path_factory.mktemp("portbench_tiny"))
    return shrink(spec.load_benchmark(), base), base


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, at run
    time, never while the test module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return "cuda"
