"""The dense cell and the two-phase cell on the CPU: the calibration of
``study_i32_d2048`` (a third of a sample's pairs pass), the new readers on
hand-made windows and on windows where the program gives nothing to read,
the metrics each new cell reports, and the ``study_job`` driver at the tiny
size, correct against the plain reference."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import gen_hashes, roofline, run, spec
from portbench.reference import minhash as mref
from portbench.trace import Trace

DENSE, TWO_PHASE = "study_dense_s8_warm", "shard_i32_twophase"
STAGE_READERS = {"shard.sweep_reruns": "sweep_reruns",
                 "shard.keep_reruns": "keep_reruns",
                 "shard.write_order_ms": "write_order_ms",
                 "shard.write_quantize_ms": "write_quantize_ms",
                 "shard.write_codec_ms": "write_codec_ms"}
SHARD_LAYER = {"shard.entry_ms", "shard.entry_host_ms",
               "shard.norms_parse_ms", "shard.sweep_ms", "shard.candidates",
               "shard.extract_ms", "shard.finalize_ms", "shard.kept_pct",
               "shard.write_ms", "shard.between_stages_ms",
               "shard.readback_bytes", "device_idle_pct.shard",
               "device_idle_unnamed_pct.shard", "shard.write_order_ms"}


def _ev(name, t0, t1, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6}


def _ctx(events, calls, traced=True, db=None):
    trace = Trace(events, 0.0, 10e6) if traced else None
    return run.Context(calls, 10.0, 1.0, db or {"n": 1000, "d": 2048,
                                                "P": 3, "max_abs": 1700},
                       trace)


def _call(rows=100, n=1000, **stages):
    return {"kind": "shard", "rows": rows, "n": n, "stages": stages}


def test_sample_of_the_dense_configuration_passes_a_third():
    """A 2,048-set sample of study_i32_d2048: the share of its pairs with
    exact set Jaccard above 0.05 lies in 0.30-0.40 (the upstream fixture's
    is 0.336), as its ``assumed`` records."""
    bench = spec.load_benchmark()
    cfg = spec.config(bench, "study_i32_d2048")
    n = 2048
    sets = gen_hashes.make_sets(dict(cfg, num_sets=n, num_vectors=n),
                                2**31 + 5, "cpu")
    ref = mref.Sets(sets["hashes"], sets["offsets"])
    inter = mref.intersections(ref, np.arange(n)).double().numpy()
    size = ref.sizes.astype(np.float64)
    union = size[:, None] + size[None, :] - inter
    jac = (inter / union)[np.triu_indices(n, 1)]
    share = float((jac > 0.05).mean())
    assert 0.30 <= share <= 0.40, share
    assert "calibration" in cfg["assumed"]


def test_new_stage_readers_take_the_mean_of_the_shards():
    keys = list(STAGE_READERS.values())
    calls = [_call(**{k: 1.0 + i for i, k in enumerate(keys)}),
             _call(**{k: 3.0 + i for i, k in enumerate(keys)}),
             {"kind": "search", "stages": {k: 9e9 for k in keys}}]
    ctx = _ctx([], calls)
    for i, (name, key) in enumerate(STAGE_READERS.items()):
        assert spec.reader(name)(ctx) == pytest.approx(2.0 + i), name
    # a program without the keys (the parent's), or no shard: nothing
    bare = _ctx([], [_call(write_ms=5.0, candidates=10)])
    for name in STAGE_READERS:
        assert spec.reader(name)(bare) is None, name
        assert spec.reader(name)(_ctx([], [])) is None, name


def test_keep_and_count_rooflines_from_the_counters_and_the_kernels():
    calls = [_call(candidates=10**6, pairs_written=3 * 10**5),
             _call(candidates=2 * 10**6, pairs_written=10**6)]
    events = [_ev("void (anonymous namespace)::partials_kernel<2, true>"
                  "(signed char const*)", 1.0, 1.01),
              _ev("void (anonymous namespace)::partials_kernel<2, true>"
                  "(signed char const*)", 2.0, 2.01),
              _ev("void (anonymous namespace)::partials_kernel<2, false>"
                  "(signed char const*)", 3.0, 4.0),
              _ev("void (anonymous namespace)::retention_kernel<false, true>"
                  "(int)", 5.0, 5.002),
              _ev("void (anonymous namespace)::retention_kernel<true, true>"
                  "(int)", 6.0, 7.0)]
    ctx = _ctx(events, calls)
    keep = sum(roofline.bound_s(2.0 * c * 4 * 2048, roofline.CORE_PEAK,
                                8.0 * c + 16.0 * w)
               for c, w in ((10**6, 3 * 10**5), (2 * 10**6, 10**6)))
    assert spec.reader("keep_roofline")(ctx) == pytest.approx(
        100.0 * keep / 0.02, rel=1e-6)
    count = roofline.count_bound_s(2 * 100 * 1000, 3, 2048)
    assert spec.reader("count_roofline")(ctx) == pytest.approx(
        100.0 * count / 0.002, rel=1e-6)
    # untraced, or a window without the kernels: nothing
    for name in ("keep_roofline", "count_roofline"):
        assert spec.reader(name)(_ctx(events, calls, traced=False)) is None
        assert spec.reader(name)(_ctx(events[4:], calls)) is None


def test_each_new_cell_reports_its_metrics():
    bench = spec.load_benchmark()
    for cell, extra in (
            (DENSE, {"append_roofline", "keep_roofline", "shard.sweep_reruns",
                     "shard.keep_reruns", "shard.write_quantize_ms",
                     "shard.write_codec_ms"}),
            (TWO_PHASE, {"count_roofline"})):
        assert {m["name"] for m in spec.metrics_of(bench, cell, False)} \
            == {"shard_pairs_per_s", "setup_s"}, cell
        assert {m["name"] for m in spec.metrics_of(bench, cell, True)} \
            == SHARD_LAYER | extra, cell
    tr = spec.traffic(spec.cell(bench, TWO_PHASE)["traffic"])
    assert tr["program_args"]["engine"] == "two_phase"
    assert spec.traffic(spec.cell(bench, DENSE)["traffic"])[
        "check_rows_per_shard"] >= 2048


def test_tiny_dense_cell_is_correct(tiny):
    """The tiny copy of the dense cell (2,000 sets at d = 256): set-up
    makes, projects and writes the sets, and the window's shards equal the
    reference on every row; traced, the new counters and spans read."""
    bench, base = tiny
    res = run.run_cell(bench, DENSE, 2**31 + 2424, 0.1, False, device="cpu",
                       root="/", base=base)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"shard_pairs_per_s", "setup_s"}
    traced = run.run_cell(bench, DENSE, 2**31 + 2425, 0.1, True,
                          device="cpu", root="/", base=base)
    assert traced["correct"], traced["checks"]
    assert set(STAGE_READERS) <= set(traced["metrics"])
    assert traced["metrics"]["shard.kept_pct"]["value"] > 0
