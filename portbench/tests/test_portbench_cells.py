"""Each cell's flow at a tiny size on the CPU: correct against the plain
reference; the control (the reference in a lower precision put in the
program's place) judged not correct; and each fault that a cell can have,
planted under the timed path, judged not correct."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from portbench import control, run

CELLS = ["shard_i32_cold", "shard_i16_deep_warm", "search_i32_b64"]
# the control of each driver: the precision below the one the
# configuration states that still changes the result (PERF.md)
CONTROL = {"shard_i32_cold": "int8", "shard_i16_deep_warm": "int8",
           "search_i32_b64": "float32"}


def _run(tiny, workload, trace=False, seconds=0.5):
    bench, base = tiny
    return run.run_cell(bench, workload, 2**31 + 77, seconds, trace,
                        device="cpu", root="/", base=base)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct(tiny, workload):
    res = _run(tiny, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-2:] == ["checks", "forbidden"]
    assert "setup_s" in res["metrics"]


@pytest.mark.parametrize("workload", ["shard_i32_cold", "search_i32_b64"])
def test_traced_cell_reports_layers(tiny, workload):
    res = _run(tiny, workload, trace=True)
    assert res["correct"]
    assert res["metrics"] and "setup_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert "idle_gaps" in res["breakdown"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, workload):
    bench, base = tiny
    prec = CONTROL[workload]
    got = control.readings(bench, workload, 5, 0.3, [prec], device="cpu",
                           root="/", base=base)["readings"]
    limits = {k: v["limit"] for k, v in _run(tiny, workload)["checks"]
              .items()}
    assert all(v <= limits[k] for k, v in got["exact"].items())
    assert any(v > limits[k] for k, v in got[prec].items()), got


# ---------------------------------------------------------------- faults

def _drop_half(compute):
    real = compute.write_shard

    def write(folder, rows, cols, vals, norms_sq, d, **kw):
        keep = rows % 2 == 0        # half of the shard's rows left out
        return real(folder, rows[keep], cols[keep], vals[keep], norms_sq, d,
                    **kw)
    return write


def _alter(compute):
    real = compute.write_shard

    def write(folder, rows, cols, vals, norms_sq, d, **kw):
        return real(folder, rows, cols, np.asarray(vals) + 4 * d, norms_sq,
                    d, **kw)
    return write


def _unchanged(compute):
    real = compute.compute_pairwise_shard
    first: dict = {}

    def shard(db, out, *a, **kw):
        folder = real(db, out, *a, **kw)
        if "folder" not in first:
            first["folder"] = folder
        elif folder != first["folder"]:
            shutil.rmtree(folder)       # the step hands back its old state
            shutil.copytree(first["folder"], folder)
        return folder
    return shard


@pytest.mark.parametrize("fault, target", [
    ("half of the batch left out", "write_shard"),
    ("an answer altered where it is produced", "write_shard"),
    ("a step that returns its state unchanged", "compute_pairwise_shard"),
])
def test_shard_fault_is_not_correct(tiny, monkeypatch, fault, target):
    from metagenome_vector_sketches_tpu_torch.matrix import compute
    make = {"half of the batch left out": _drop_half,
            "an answer altered where it is produced": _alter,
            "a step that returns its state unchanged": _unchanged}[fault]
    monkeypatch.setattr(compute, target, make(compute))
    res = _run(tiny, "shard_i32_cold", seconds=1.0)
    assert res["attempted"] >= 2
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("fault", [
    "half of the batch left out", "an answer altered where it is produced",
    "a step that returns its state unchanged"])
def test_search_fault_is_not_correct(tiny, monkeypatch, fault):
    from metagenome_vector_sketches_tpu_torch.ann import search
    real_rescore, real_search = search.rescore, search.search_index
    if fault == "half of the batch left out":
        def rescore(hits, qn, names, norms, j, verbose=True):
            out = real_rescore(hits, qn, names, norms, j, verbose)
            return [h for h in out if h[0] % 2 == 0]
        monkeypatch.setattr(search, "rescore", rescore)
    elif fault == "an answer altered where it is produced":
        def rescore(hits, qn, names, norms, j, verbose=True):
            out = real_rescore(hits, qn, names, norms, j, verbose)
            return [(q, n, jac * (1 + 1e-6)) for q, n, jac in out]
        monkeypatch.setattr(search, "rescore", rescore)
    else:
        first: list = []

        def search_index(*a, **kw):
            if not first:
                first.append(real_search(*a, **kw))
            return first[0]
        monkeypatch.setattr(search, "search_index", search_index)
    res = _run(tiny, "search_i32_b64", seconds=1.0)
    assert not res["correct"], (fault, res["checks"])
