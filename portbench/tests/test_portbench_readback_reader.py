"""The reader of the program's ``readback_bytes`` stage record
(portbench/metrics/shard.readback_bytes.py) on hand-made windows: the mean
over the window's shard calls, and no value where the program gives no such
key (a build whose fused engine still copies kernel X's partials out)."""

from __future__ import annotations

from portbench import run, spec
from portbench.trace import Trace

METRIC = "shard.readback_bytes"


def _ctx(calls, t1=10.0):
    return run.Context(calls, t1, 1.0, {}, Trace([], 0.0, t1 * 1e6))


def _shard_call(**stages):
    return {"kind": "shard", "stages": stages}


def test_readback_reader_takes_the_mean_of_the_stage_records():
    calls = [_shard_call(readback_bytes=1600, total_ms=5.0),
             _shard_call(readback_bytes=2400, total_ms=7.0),
             {"kind": "search", "stages": {"readback_bytes": 9e9}}]
    assert spec.reader(METRIC)(_ctx(calls)) == 2000.0


def test_readback_reader_reads_nothing_without_the_key():
    read = spec.reader(METRIC)
    assert read(_ctx([_shard_call(total_ms=5.0, sweep_ms=1.0)])) is None
    assert read(_ctx([])) is None
