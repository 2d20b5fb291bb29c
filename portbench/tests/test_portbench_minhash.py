"""The MinHash cell's parts on the CPU: its readers on hand-made windows
(a synthetic Trace and calls with stage records) and on windows where the
program gives nothing to read; the metrics each new cell reports; and the
``minhash_job`` driver at a tiny size: correct against the plain reference,
its int16 control and a program without the light postings judged not
correct, and a program without the staged-sets slot refused at once."""

from __future__ import annotations

import copy
import json
import os
import time

import pytest

from portbench import roofline, run, spec
from portbench.trace import Trace

STAGE_READERS = {"minhash.heavy_ms": "heavy_ms", "minhash.light_ms":
                 "light_ms", "minhash.keep_ms": "keep_ms",
                 "minhash.cooccurrences": "light_cooccurrences"}
MINHASH_LAYER = ("minhash.heavy_ms", "minhash.light_ms", "minhash.keep_ms",
                 "shard.write_ms", "minhash.cooccurrences",
                 "minhash.kept_pct", "gram_roofline", "cooc_roofline",
                 "device_idle_pct.shard", "device_idle_unnamed_pct.shard")
WARM_LAYER = ("shard.entry_host_ms", "shard.sweep_ms", "shard.candidates",
              "append_roofline", "shard.extract_ms", "shard.finalize_ms",
              "shard.kept_pct", "shard.write_ms", "shard.between_stages_ms",
              "device_idle_pct.shard", "shard.entry_ms",
              "shard.norms_parse_ms", "device_idle_unnamed_pct.shard",
              "shard.readback_bytes")


def _ev(name, t0, t1, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6}


def _ctx(events, calls, t1=10.0, traced=True):
    trace = Trace(events, 0.0, t1 * 1e6) if traced else None
    return run.Context(calls, t1, 1.0, {"n": 1000}, trace)


def _call(rows=100, n=1000, **stages):
    return {"kind": "shard", "rows": rows, "n": n, "stages": stages}


def _stages(k):
    return {"heavy_ms": 2.0 * k, "light_ms": 3.0 * k, "keep_ms": 1.0 * k,
            "write_ms": 5.0 * k, "light_cooccurrences": 1000 * k,
            "light_entries": 400, "light_postings": 99, "heavy_hashes": 64,
            "emitted": 100_000, "pairs_written": 250 * k}


def test_stage_readers_take_the_mean_of_the_shards():
    calls = [_call(**_stages(1)), _call(**_stages(3)),
             {"kind": "search", "stages": {"heavy_ms": 9e9}}]
    ctx = _ctx([], calls)
    for name, key in STAGE_READERS.items():
        want = (_stages(1)[key] + _stages(3)[key]) / 2
        assert spec.reader(name)(ctx) == pytest.approx(want), name
    assert spec.reader("minhash.kept_pct")(ctx) == pytest.approx(
        100.0 * 1000 / 200_000)
    # the writer's time of a MinHash shard is the sketch shards' reader's
    assert spec.reader("shard.write_ms")(ctx) == pytest.approx(10.0)


def test_readers_read_nothing_from_a_sketch_shard_or_no_shard():
    """A sketch shard's record (write_ms, emitted, but no MinHash stage)
    and a window of no shard give nothing to read."""
    sketch = _ctx([], [_call(write_ms=7.0, emitted=10, pairs_written=1,
                             sweep_ms=3.0)])
    empty = _ctx([], [])
    for name in list(STAGE_READERS) + ["minhash.kept_pct", "gram_roofline",
                                       "cooc_roofline"]:
        assert spec.reader(name)(sketch) is None, name
        assert spec.reader(name)(empty) is None, name


def test_rooflines_from_the_counters_and_the_kernels():
    calls = [_call(**_stages(1)), _call(**_stages(2))]
    events = [_ev("(anonymous namespace)::gemm_kernel<4>(CUtensorMap_st)",
                  1.0, 1.004),
              _ev("(anonymous namespace)::cooc_kernel(int const*)", 2.0,
                  2.0001),
              _ev("(anonymous namespace)::cooc_kernel(int const*)", 3.0,
                  3.0001),
              _ev("(anonymous namespace)::gemm_kernel<2>(CUtensorMap_st)",
                  4.0, 5.0)]
    ctx = _ctx(events, calls)
    ops = 2.0 * 100 * 1000 * 64
    gram = 2 * max(ops / roofline.INT8_PEAK,
                   ((100 + 1000) * 64 + 4.0 * 100 * 1000) / roofline.HBM_RATE)
    assert spec.reader("gram_roofline")(ctx) == pytest.approx(
        100.0 * gram / 0.004, rel=1e-6)
    nbytes = sum(4.0 * 400 + 8.0 * 100 + 8.0 * 1000 * k for k in (1, 2))
    assert spec.reader("cooc_roofline")(ctx) == pytest.approx(
        100.0 * nbytes / roofline.HBM_RATE / 0.0002, rel=1e-6)
    # untraced, or a trace without the kernels: nothing
    assert spec.reader("gram_roofline")(_ctx(events, calls, traced=False)) \
        is None
    assert spec.reader("cooc_roofline")(_ctx(events[3:], calls)) is None


def test_each_new_cell_reports_its_metrics():
    bench = spec.load_benchmark()
    for cell, layer in (("minhash_exact_s8_warm", MINHASH_LAYER),
                        ("shard_i32_warm", WARM_LAYER)):
        assert {m["name"] for m in spec.metrics_of(bench, cell, False)} \
            == {"shard_pairs_per_s", "setup_s"}
        assert {m["name"] for m in spec.metrics_of(bench, cell, True)} \
            == set(layer), cell
    w = spec.cell(bench, "shard_i32_warm")
    assert spec.traffic(w["traffic"])["cache"] == "warm"
    assert spec.config(bench, "sra_minhash_exact")["num_sets"] == 24576


# ---------------------------------------------------------------- the driver

@pytest.fixture(scope="module")
def tiny_mh(tiny):
    """The benchmark with a tiny MinHash cell: 288 sets (hashes of 3 sets
    or more heavy, so both kinds of work run; sizes log-uniform up to
    40,000, so that some rows' counts pass the int16 range), a pool of
    2^17, a 3-shard job."""
    bench, base = tiny
    bench = copy.deepcopy(bench)
    cfg = spec.config(bench, "sra_minhash_exact", "/")
    cfg.update(num_sets=288, set_sizes={"law": "log_uniform", "low": 1,
                                        "high": 40000})
    cfg["sharing"]["pool_size"] = 1 << 17
    path = os.path.join(base, "configs", "minhash_tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "minhash_tiny", "source": "tiny",
                             "file": path, "reduced": [], "why": "tiny"})
    tr = spec.traffic("minhash_s8_warm")
    tr.update(num_shards=3, check_rows_per_shard=32)
    with open(os.path.join(base, "traffic", "minhash_tiny.json"), "w") as f:
        json.dump(tr, f)
    bench["workloads"].append({"name": "minhash_tiny", "config":
                               "minhash_tiny", "traffic": "minhash_tiny",
                               "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "minhash_exact_s8_warm" in m.get("workloads", ()):
            m["workloads"].append("minhash_tiny")
    return bench, base


def _run(tiny_mh, trace=False, seconds=0.5):
    bench, base = tiny_mh
    return run.run_cell(bench, "minhash_tiny", 2**31 + 4242, seconds, trace,
                        device="cpu", root="/", base=base)


def test_tiny_minhash_cell_is_correct(tiny_mh):
    res = _run(tiny_mh)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 3
    assert set(res["metrics"]) == {"shard_pairs_per_s", "setup_s"}
    traced = _run(tiny_mh, trace=True)
    assert traced["correct"]
    # the CPU runs no kernel: the rooflines have nothing to read
    assert {"minhash.heavy_ms", "minhash.light_ms", "minhash.keep_ms",
            "shard.write_ms", "minhash.cooccurrences",
            "minhash.kept_pct"} <= set(traced["metrics"])
    assert traced["metrics"]["minhash.cooccurrences"]["value"] > 0


def test_int16_control_is_not_correct(tiny_mh):
    from portbench import control
    bench, base = tiny_mh
    got = control.readings(bench, "minhash_tiny", 7, 0.3, ["int16"],
                           device="cpu", root="/", base=base)["readings"]
    assert all(v == 0 for v in got["exact"].values())
    assert got["int16"]["rows_differing"] > 0


def test_a_program_without_the_light_postings_is_not_correct(tiny_mh,
                                                             monkeypatch):
    from metagenome_vector_sketches_tpu_torch.ops import minhash
    monkeypatch.setattr(minhash, "cooc_accumulate_plain",
                        lambda C, *a: C)
    res = _run(tiny_mh)
    assert not res["correct"]
    assert res["checks"]["rows_differing"]["value"] > 0


def test_a_program_without_the_slot_fails_at_once(tiny_mh, monkeypatch):
    from metagenome_vector_sketches_tpu_torch.matrix import compute
    monkeypatch.delattr(compute, "stage_minhash_sets")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="staged-sets slot"):
        _run(tiny_mh)
    assert time.perf_counter() - t0 < 5.0
