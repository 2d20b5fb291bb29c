"""The stage spans of the port's shard and search entries
(utils.profiling.stage). Under torch.profiler every stage of a call is a
profiler span nested in the call's own span, mvs.shard#<n> or
mvs.search#<n>, with n one more each call; without a profiler no
record_function is entered; the shard's stage keys of its own (entry,
norms parse) time only work that no other key timed, and the fused
engines, whose kernel X combines, tests and mirrors on the device, enter
neither the host's combine nor its mirror. The writer's stages (its
ordering, quantisation and codec) are spans of their own, mvs.write.order,
mvs.write.quantize and mvs.write.codec, inside the caller's write span,
and their walls sum to no more than the write's."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metagenome_vector_sketches_tpu_torch.ann import search as tsearch
from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu_torch.io.hashes import (
    parse_hashes_file, write_hashes_file)
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
from metagenome_vector_sketches_tpu_torch.utils import profiling

TILE = 32
# the stage spans each engine's first shard of a fresh db opens
SHARD_SPANS = {
    "resident": {"entry", "norms_parse", "stage", "stage_wait", "stage_h2d",
                 "decompose", "sweep", "extract", "finalize", "write",
                 "write.order", "write.quantize", "write.codec"},
    "streaming": {"entry", "norms_parse", "stage", "stage_wait",
                  "stage_h2d", "decompose", "sweep", "extract", "finalize",
                  "write", "write.order", "write.quantize", "write.codec"},
    "two_phase": {"entry", "norms_parse", "stage", "stage_wait", "stage_h2d",
                  "decompose", "sweep", "extract", "finalize", "write",
                  "write.order", "write.quantize", "write.codec"},
}
SEARCH_SPANS = {"db_norms", "parse_queries", "project", "index", "adaptive",
                "prep", "enqueue", "wait", "frontier", "collect", "rescore"}
WALLS = ("stage_ms", "sweep_ms", "extract_ms", "finalize_ms", "write_ms")
WRITE_SPANS = ("mvs.write.order", "mvs.write.quantize", "mvs.write.codec")
WRITE_WALLS = ("write_order_ms", "write_quantize_ms", "write_codec_ms")


def _db(path, n=160, d=64, seed=3):
    """L = 2 rows with a group of near-duplicates across the first three
    tiles, so that the sweep keeps pairs off the diagonal tiles too."""
    rng = np.random.default_rng(seed)
    V = rng.integers(-3000, 3001, size=(n, d)).astype(np.int32)
    V[20:80] = np.clip(V[5] + rng.integers(-3, 4, size=(60, d)), -3000,
                       3000)
    return DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d)


def _shard(db, out, engine):
    kw = {"device_budget_bytes": 0} if engine == "streaming" else {}
    tmc.compute_pairwise_shard(
        db.path, str(out), num_shards=2, shard_idx=0, tile_rows=TILE,
        verbose=False, device="cpu",
        engine="two_phase" if engine == "two_phase" else "fused", **kw)
    return dict(tmc.LAST_STAGES)


@pytest.fixture(scope="module")
def toy_search(tmp_path_factory, ref_toy_dir):
    """toy_db_2048 and a query file of 6 of its own accessions."""
    root = tmp_path_factory.mktemp("spans_toy")
    db = root / "db"
    shutil.copytree(str(ref_toy_dir / "toy_db_2048"), db)
    named = dict(parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt")))
    names, _ = DbFolder(str(db)).names_and_norms()
    qf = str(root / "q.txt")
    write_hashes_file(qf, [(n, named[n]) for n in names[:30:5]])
    return str(db), qf


def _search(toy):
    return tsearch.search_index(*toy, 0.1, verbose=False, engine="int8",
                                device="cpu")


def _profiled(run, tmp_path):
    """-> [(name, start us, end us, thread)] of the mvs.* spans of run()
    under torch.profiler, from its Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("mvs.")]


def _by_call(spans, kind):
    """-> [(call number, {stage names})], the calls in order: every stage
    span lies inside exactly one call span of its thread. The writer's
    spans (mvs.write.<stage>) are named "write.<stage>"."""
    calls = sorted((s for s in spans if "#" in s[0]), key=lambda s: s[1])
    assert calls and all(c[0].startswith(f"mvs.{kind}#") for c in calls)
    inside = [set() for _ in calls]
    for name, b, e, tid in spans:
        if "#" in name:
            continue
        assert name.startswith((f"mvs.{kind}.", "mvs.write.")), name
        home = [i for i, c in enumerate(calls)
                if c[3] == tid and c[1] <= b + 1 and e <= c[2] + 1]
        assert len(home) == 1, (name, b, e)
        inside[home[0]].add(name.removeprefix(f"mvs.{kind}.")
                            .removeprefix("mvs."))
    return [(int(c[0].split("#")[1]), st) for c, st in zip(calls, inside)]


def _nested(spans, inner, outer):
    """Every span named inner lies inside a span named outer of its
    thread, and there is one."""
    outs = [s for s in spans if s[0] == outer]
    ins = [s for s in spans if s[0] == inner]
    assert ins
    for _, b, e, tid in ins:
        assert any(o[3] == tid and o[1] <= b + 1 and e <= o[2] + 1
                   for o in outs), (inner, b, e)


@pytest.mark.parametrize("engine", sorted(SHARD_SPANS))
def test_shard_stages_are_spans_of_their_call(tmp_path, engine):
    db = _db(tmp_path / "db")
    tmc.clear_device_cache()

    def run():
        _shard(db, tmp_path / "a", engine)
        _shard(db, tmp_path / "b", engine)
    spans = _profiled(run, tmp_path)
    (n1, first), (n2, second) = _by_call(spans, "shard")
    for inner in WRITE_SPANS:
        _nested(spans, inner, "mvs.shard.write")
    assert n2 == n1 + 1
    assert first == SHARD_SPANS[engine]
    # a resident shard of the same db re-uses the staged planes
    assert second == (first - {"stage_wait", "stage_h2d", "decompose"}
                      if engine != "streaming" else first)


@pytest.mark.parametrize("budget", [None, 0], ids=["resident",
                                                   "streaming"])
def test_two_phase_finalize_is_not_inside_extract(tmp_path, budget):
    """A two-phase shard's extract_ms times the extraction's launches and
    copies only: no mvs.shard.finalize span lies inside an
    mvs.shard.extract span, and the finalize still runs."""
    db = _db(tmp_path / "db")
    tmc.clear_device_cache()
    spans = _profiled(lambda: tmc.compute_pairwise_shard(
        db.path, str(tmp_path / "m"), num_shards=2, shard_idx=0,
        tile_rows=TILE, device_budget_bytes=budget, verbose=False,
        device="cpu", engine="two_phase"), tmp_path)
    assert tmc.LAST_STAGES["mode"].startswith("two_phase")
    extract = [(b, e) for n, b, e, _ in spans if n == "mvs.shard.extract"]
    final = [(b, e) for n, b, e, _ in spans if n == "mvs.shard.finalize"]
    assert extract and final
    assert not [f for f in final for x in extract
                if x[0] <= f[0] and f[1] <= x[1]]
    assert tmc.LAST_STAGES["extract_ms"] > 0
    assert tmc.LAST_STAGES["finalize_ms"] > 0


def test_search_stages_are_spans_of_their_call(tmp_path, toy_search):
    tsearch.clear_index_cache()
    hits = []

    def run():
        hits.append(_search(toy_search))
        hits.append(_search(toy_search))
    (n1, first), (n2, second) = _by_call(_profiled(run, tmp_path), "search")
    assert n2 == n1 + 1
    assert first == second == SEARCH_SPANS
    assert hits[0] == hits[1] and hits[0]
    assert tsearch.LAST_ADAPTIVE_STAGES["rounds"] >= 1


def test_minhash_stages_are_spans(tmp_path, monkeypatch):
    """A MinHash shard's stages are spans of its call: the staging (only
    while the slot is empty), kernel G, kernel C, kernel M with the
    copies, and the writer; its counters say what each did."""
    sets = [np.arange(i, i + 50, dtype=np.uint64) for i in range(0, 200, 10)]
    path = str(tmp_path / "h.txt")
    write_hashes_file(path, [(f"S{i}", s) for i, s in enumerate(sets)])
    # hashes of 3 sets or more heavy: both kinds of work run
    monkeypatch.setattr(tmc.minhash, "heavy_threshold", lambda p, n: 3)
    tmc.clear_device_cache()

    def run():
        for k in range(2):
            tmc.compute_minhash_shard(path, str(tmp_path / "m"), 2, k,
                                      verbose=False, device="cpu")
    spans = _profiled(run, tmp_path)
    (n1, first), (n2, second) = _by_call(spans, "minhash")
    for inner in WRITE_SPANS:
        _nested(spans, inner, "mvs.minhash.write")
    assert n2 == n1 + 1
    assert first == {"stage", "heavy", "light", "keep", "write",
                     "write.order", "write.quantize", "write.codec"}
    assert second == first          # the slot hit is an empty stage span
    st = tmc.LAST_STAGES
    assert {"stage_ms", "heavy_ms", "light_ms", "keep_ms", "write_ms",
            "heavy_hashes", "light_cooccurrences", "emitted",
            "pairs_written", "stage_bytes", "write_order_ms",
            "write_presorted"} <= set(st)
    assert st["heavy_hashes"] > 0 and st["light_cooccurrences"] > 0
    assert st["emitted"] == 10 * 20 and st["stage_bytes"] == 0
    assert 0 < st["pairs_written"] <= st["emitted"]
    assert not {"universe_ms", "gram_ms", "copy_ms"} & set(st)
    tmc.clear_device_cache()


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch,
                                               toy_search):
    """Tracing off, the stages enter no record_function; on, they do."""
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(profiling, "record_function", counting)
    db = _db(tmp_path / "db")
    _shard(db, tmp_path / "m", "resident")
    _search(toy_search)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _shard(db, tmp_path / "m2", "resident")
    assert "mvs.shard.sweep" in entered
    assert any(n.startswith("mvs.shard#") for n in entered)


@pytest.mark.parametrize("engine", ["resident", "streaming"])
def test_new_stage_keys_time_only_untimed_work(tmp_path, engine,
                                               monkeypatch):
    """The fused engines read back kernel X's kept pairs and counters
    alone, not every candidate's partials (20 B a candidate at L = 2), and
    the host neither combines nor mirrors: combine_ms and mirror_ms stay
    0.0; the norms parse is part of the entry, before total_ms."""
    reads = []
    read_kept = pw.read_kept
    monkeypatch.setattr(pw, "read_kept",
                        lambda *a: reads.append(1) or read_kept(*a))
    db = _db(tmp_path / "db")
    tmc.clear_device_cache()
    st = _shard(db, tmp_path / "m", engine)
    assert "dispatch_walls_ms" not in st
    assert st["combine_ms"] == 0.0 and st["mirror_ms"] == 0.0
    # kernel X's kept pairs (written, self-pairs and twins included) and
    # one counter record for each of its readbacks, and nothing more
    extra = st["readback_bytes"] - pw.KEPT_BYTES * st["pairs_written"]
    assert reads and extra == pw.COUNTER_BYTES * len(reads)
    assert sum(st[k] for k in WALLS) <= st["total_ms"]
    assert 0 < st["norms_parse_ms"] <= st["entry_ms"]


@pytest.mark.parametrize("engine", sorted(SHARD_SPANS))
def test_write_stages_split_the_write(tmp_path, engine):
    """Each engine's write is split into its ordering, quantisation and
    codec: one span each under a profiler, inside the write span, and walls
    that sum to no more than write_ms, untraced and traced."""
    db = _db(tmp_path / "db")
    tmc.clear_device_cache()
    st = _shard(db, tmp_path / "a", engine)
    assert st["pairs_written"] > 0
    assert all(st[k] >= 0.0 for k in WRITE_WALLS)
    assert sum(st[k] for k in WRITE_WALLS) <= st["write_ms"]
    spans = _profiled(lambda: st.update(_shard(db, tmp_path / "b", engine)),
                      tmp_path)
    for inner in WRITE_SPANS:
        assert sum(n == inner for n, *_ in spans) == 1, inner
        _nested(spans, inner, "mvs.shard.write")
    assert sum(st[k] for k in WRITE_WALLS) <= st["write_ms"]
