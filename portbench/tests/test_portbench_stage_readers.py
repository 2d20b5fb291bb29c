"""The readers of the program's own stages (portbench/stages.py and the
metrics that use it) on hand-made windows: a synthetic Trace of device
intervals and ``mvs.`` spans, and calls with stage records; and, where the
program gives neither (a build without the spans or keys), no value. Then
the traced tiny cells on the CPU, which read the span metrics off the
program itself."""

from __future__ import annotations

import pytest

from portbench import run, spec
from portbench.trace import Trace

SHARD_READERS = ("shard.entry_ms", "shard.norms_parse_ms", "shard.combine_ms",
                 "shard.mirror_ms")
SEARCH_READERS = ("search.query_parse_ms", "search.db_norms_ms",
                  "search.project_ms", "search.rescore_ms")


def _ev(name, t0, t1, cat="user_annotation"):
    """A Chrome trace event over [t0, t1] seconds."""
    return {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
            "dur": (t1 - t0) * 1e6}


def _ctx(events, calls, t1=10.0):
    return run.Context(calls, t1, 1.0, {}, Trace(events, 0.0, t1 * 1e6))


def _read(name, ctx):
    return spec.reader(name)(ctx)


def _shard_call(**stages):
    return {"kind": "shard", "stages": stages}


def test_shard_readers_take_the_mean_of_the_stage_records():
    calls = [_shard_call(entry_ms=300.0, norms_parse_ms=200.0,
                         combine_ms=1000.0, mirror_ms=50.0),
             _shard_call(entry_ms=100.0, norms_parse_ms=80.0,
                         combine_ms=3000.0, mirror_ms=150.0),
             {"kind": "search", "stages": {"entry_ms": 9e9}}]
    ctx = _ctx([], calls)
    got = {m: _read(m, ctx) for m in SHARD_READERS}
    assert got == {"shard.entry_ms": 200.0, "shard.norms_parse_ms": 140.0,
                   "shard.combine_ms": 2000.0, "shard.mirror_ms": 100.0}


def test_shard_readers_read_nothing_without_the_keys():
    ctx = _ctx([], [_shard_call(total_ms=5.0, sweep_ms=1.0)])
    assert all(_read(m, ctx) is None for m in SHARD_READERS)


def test_search_readers_sum_spans_over_the_requests():
    events = []
    for i, t in enumerate((0.0, 4.0)):            # two requests
        events += [_ev(f"portbench.search_{i}", t, t + 2.0),
                   _ev(f"mvs.search#{i + 1}", t + 0.1, t + 1.9),
                   _ev("mvs.search.db_norms", t + 0.1, t + 0.4),
                   _ev("mvs.search.parse_queries", t + 0.4, t + 1.0),
                   _ev("mvs.search.project", t + 1.0, t + 1.05),
                   _ev("mvs.search.adaptive", t + 1.05, t + 1.5),
                   _ev("mvs.search.rescore", t + 1.5, t + 1.9)]
    calls = [{"kind": "search", "stages": {}} for _ in range(2)]
    ctx = _ctx(events, calls)
    got = {m: _read(m, ctx) for m in SEARCH_READERS}
    want = {"search.query_parse_ms": 600.0, "search.db_norms_ms": 300.0,
            "search.project_ms": 50.0, "search.rescore_ms": 400.0}
    assert got.keys() == want.keys()
    for m in want:
        assert got[m] == pytest.approx(want[m], rel=1e-9), m
    # a build without the spans, or no request: nothing to read
    bare = _ctx([e for e in events if not e["name"].startswith("mvs.")],
                calls)
    assert all(_read(m, bare) is None for m in SEARCH_READERS)
    assert all(_read(m, _ctx(events, [])) is None for m in SEARCH_READERS)


def _shard_window():
    """One shard call over [1, 9] s: stage spans cover [1.5, 4] and
    [5, 8.5] (entry span [1.2, 8.8] does not count); the device is busy
    over [0, 2] and [6, 7], and outside the call over [9.5, 10]."""
    events = [_ev("portbench.shard_0", 1.0, 9.0),
              _ev("mvs.shard#7", 1.2, 8.8),
              _ev("mvs.shard.entry", 1.5, 2.5),
              _ev("mvs.shard.norms_parse", 1.6, 2.4),
              _ev("mvs.shard.sweep", 2.5, 4.0),
              _ev("mvs.shard.combine", 5.0, 6.5),
              _ev("mvs.shard.finalize", 6.5, 8.5),
              _ev("aten::add", 4.2, 4.3, cat="cpu_op"),
              _ev("kernel_a", 0.0, 2.0, cat="kernel"),
              _ev("Memcpy DtoH", 6.0, 7.0, cat="gpu_memcpy"),
              _ev("kernel_b", 9.5, 10.0, cat="kernel")]
    return events, [_shard_call(entry_ms=1000.0)]


def test_unnamed_idle_share_of_the_calls():
    events, calls = _shard_window()
    # idle inside the call: [2, 6] and [7, 9] = 6 s; named by stages:
    # [2, 4] and [5, 6] and [7, 8.5] = 4.5 s; unnamed 1.5 s
    got = _read("device_idle_unnamed_pct.shard", _ctx(events, calls))
    assert got == pytest.approx(100.0 * 1.5 / 6.0, rel=1e-9)
    # the search reader finds no request here
    assert _read("device_idle_unnamed_pct.search",
                 _ctx(events, calls)) is None


def test_unnamed_idle_share_reads_nothing_without_spans_or_device():
    events, calls = _shard_window()
    bare = [e for e in events
            if not (e["name"].startswith("mvs.") and "#" not in e["name"])]
    assert _read("device_idle_unnamed_pct.shard", _ctx(bare, calls)) is None
    host_only = [e for e in events if e["cat"] == "user_annotation"]
    assert _read("device_idle_unnamed_pct.shard",
                 _ctx(host_only, calls)) is None


def test_unnamed_idle_share_of_requests_leaves_out_the_waits():
    # a wait for the due time outside the request is not the program's
    events = [_ev("portbench.until_due", 0.0, 1.0),
              _ev("portbench.search_0", 1.0, 2.0),
              _ev("mvs.search#1", 1.0, 2.0),
              _ev("mvs.search.parse_queries", 1.0, 1.8),
              _ev("kernel_c", 1.9, 2.0, cat="kernel")]
    ctx = _ctx(events, [{"kind": "search", "stages": {}}], t1=2.0)
    got = _read("device_idle_unnamed_pct.search", ctx)
    assert got == pytest.approx(100.0 * 0.1 / 0.9, rel=1e-9)


@pytest.mark.parametrize("workload, names", [
    ("shard_i32_cold", SHARD_READERS),
    ("search_i32_b64", SEARCH_READERS)])
def test_traced_tiny_cell_reads_the_program_stages(tiny, workload, names):
    bench, base = tiny
    res = run.run_cell(bench, workload, 2**31 + 91, 0.5, True, device="cpu",
                       root="/", base=base)
    assert res["correct"]
    got = res["metrics"]
    assert all(got[m]["value"] >= 0 for m in names), got
    if workload == "shard_i32_cold":
        assert got["shard.norms_parse_ms"]["value"] \
            <= got["shard.entry_ms"]["value"]
