"""BENCHMARK.json against the benchmark's contract, and discovery of
configurations, traffic mixes and metrics by name: a new one is a new file
and a new entry, with no file that is already there edited."""

from __future__ import annotations

import copy
import json
import os
import re

import pytest

from portbench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["portbench"]
    assert all(TEXT.match(w) for w in bench["command"])
    assert len(json.dumps(bench)) < 64 << 10


def test_names_units_and_texts(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert TEXT.match(w["why"]) and w["chips"] == 1
        assert NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and all(NAME.match(k)
                                               for k in c["reduced"])


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] == 0.25


def test_every_cell_reports_what_the_contract_asks(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = {m["name"] for m in spec.metrics_of(bench, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = spec.metrics_of(bench, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in mine
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_has_its_file(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = spec.config(bench, c["name"])
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert {"source", "deployment", "assumed"} <= set(cfg)
    for w in bench["workloads"]:
        assert spec.traffic(w["traffic"])["driver"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def _added(bench, base):
    """A new configuration, traffic mix and metric, as new files and
    entries beside the tiny copies."""
    bench = copy.deepcopy(bench)
    src = [c for c in bench["configs"] if c["name"] == "sra_i32_d2048"][0]
    with open(src["file"]) as f:
        cfg = json.load(f)
    cfg["name"] = "dummy_cfg"
    path = os.path.join(base, "configs", "dummy_cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    bench["configs"].append(dict(src, name="dummy_cfg", file=path))
    with open(os.path.join(base, "traffic", "shard_s8_cold.json")) as f:
        tr = json.load(f)
    tr["num_shards"] = 3
    with open(os.path.join(base, "traffic", "dummy_mix.json"), "w") as f:
        json.dump(tr, f)
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a cell added as files only"})
    with open(os.path.join(base, "metrics", "dummy.calls.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.calls)\n")
    bench["per_layer"].append({"name": "dummy.calls", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves":
                               "shard_pairs_per_s",
                               "workloads": ["dummy_cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "shard_pairs_per_s":
            m["workloads"].append("dummy_cell")
    return bench


@pytest.mark.parametrize("trace", [False, True])
def test_new_files_are_found_by_name(tiny, trace):
    bench, base = tiny
    bench = _added(bench, base)
    res = run.run_cell(bench, "dummy_cell", 11, 0.5, trace, device="cpu",
                       root="/", base=base)
    assert res["correct"] and not res["forbidden"]
    want = "dummy.calls" if trace else "shard_pairs_per_s"
    assert want in res["metrics"]
    if trace:
        assert res["metrics"]["dummy.calls"]["value"] == res["attempted"]


REVERSED = '''"""Driver ``reversed_job``: the shard job, its shards from the last to
the first."""

import os

from portbench import spec

_Job = spec.driver("shard_job",
                   os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Driver(_Job):
    def call(self, i, due=None):
        S = self.S
        return super().call(i // S * S + S - 1 - i % S, due)
'''


@pytest.mark.parametrize("case", ["device_budget_bytes", "a new driver",
                                  "the f32 engine"])
def test_new_drivers_and_program_args_need_no_edit(tiny, case):
    """A traffic file whose ``program_args`` reach the program's entry
    unchanged, and a driver that is a new file, run with no file that is
    already there edited."""
    bench, base = tiny
    if case == "the f32 engine":
        tr = spec.traffic("search_b64", base)
        tr["program_args"] = {"engine": "f32"}
        # the f32 engine rescores in float32 (FAISS parity): its cell sets
        # its own limit from its readings; here one that float32 rounding
        # (~5e-7 at this size) passes
        tr["jaccard_gap_limit"] = 1e-5
        config, like = "sra_i32_d2048", "search_i32_b64"
    else:
        tr = spec.traffic("shard_s8_cold", base)
        cfg = spec.config(bench, "sra_i32_d2048", "/")
        planes = 3 * cfg["num_vectors"] * cfg["dimension"]
        tr["program_args"]["device_budget_bytes"] = planes // 2
        config, like = "sra_i32_d2048", "shard_i32_cold"
        if case == "a new driver":
            with open(os.path.join(base, "drivers", "reversed_job.py"),
                      "w") as f:
                f.write(REVERSED)
            tr["driver"] = "reversed_job"
    name = "added_" + case.replace(" ", "_")
    bench = copy.deepcopy(bench)
    with open(os.path.join(base, "traffic", f"{name}.json"), "w") as f:
        json.dump(tr, f)
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": name, "chips": 1,
                               "why": "a cell added as files only"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    for trace in (False, True):
        res = run.run_cell(bench, name, 13, 1.0, trace, device="cpu",
                           root="/", base=base)
        assert res["correct"], (case, res["checks"])
        assert res["metrics"] and not res["forbidden"]
    if case == "a new driver":
        assert res["attempted"] >= 2
