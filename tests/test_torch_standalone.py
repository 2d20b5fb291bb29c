"""The port stands alone: it imports nothing of the JAX package, and its
own copies of the JAX package's host layers (codecs, db folders, hashes
files, the shard reader, the FAISS index file, the query engine) behave
exactly like the originals on seeded inputs; its own shard writer writes
the same files as the JAX package's."""

import filecmp
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu import codecs as j_codecs  # noqa: E402
from metagenome_vector_sketches_tpu.ann import faissio as j_faissio  # noqa: E402
from metagenome_vector_sketches_tpu.io import dbfolder as j_dbfolder  # noqa: E402
from metagenome_vector_sketches_tpu.io import hashes as j_hashes  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import reader as j_reader  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import writer as j_writer  # noqa: E402
from metagenome_vector_sketches_tpu.query import engine as j_engine  # noqa: E402
from metagenome_vector_sketches_tpu_torch import codecs as t_codecs  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import faissio as t_faissio  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io import dbfolder as t_dbfolder  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io import hashes as t_hashes  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import reader as t_reader  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import writer as t_writer  # noqa: E402
from metagenome_vector_sketches_tpu_torch.query import engine as t_engine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "metagenome_vector_sketches_tpu_torch"


def test_port_alone_walkthrough(tmp_path):
    """A fresh interpreter imports every module of the port and drives the
    CPU walkthrough through its command-line tools: sketch -> pairwise_comp
    -> query_pc_mat (and the pybind drop-in) -> jaccard index / search ->
    pairwise_comp --strategy 1, then the multi-device layer (parallel/,
    ann/distributed.py) on a 2-slot CPU mesh. Neither jax nor any module of
    the JAX package gets loaded."""
    t = str(tmp_path)
    code = f"""
import importlib, os, pkgutil, sys
sys.path.insert(0, {REPO!r})
import numpy as np
import {PKG} as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from {PKG}.cli import (jaccard, pairwise_comp, project_everything,
                       query_pc_mat)
rng = np.random.default_rng(0)
base = rng.integers(0, 2**63, size=60, dtype=np.uint64)
with open(os.path.join({t!r}, "h.txt"), "w") as f:
    for i in range(48):
        hs = rng.integers(0, 2**63, size=60, dtype=np.uint64)
        if i % 4:
            hs[:40] = base[:40] + np.uint64(i // 4)
        f.write(f"A{{i}}: " + " ".join(map(str, hs.tolist())) + "\\n")
t = {t!r}
p = lambda *x: os.path.join(t, *x)
assert project_everything.main(["sketch", p("h.txt"), p("db"), "-d", "128",
                                "--device", "cpu"]) == 0
base_args = ["--db", p("db"), "--max_memory_gb", "1", "--num_threads", "1",
             "--num_shards", "1", "--shard_idx", "0", "--device", "cpu"]
assert pairwise_comp.main(base_args + ["--output_folder", p("m")]) == 0
with open(p("q.txt"), "w") as f:
    f.write("A1\\nA5\\n")
assert query_pc_mat.main(["--matrix", p("m"), "--db", p("db"),
                          "--query_file", p("q.txt"), "--top", "3",
                          "--write_to_file", p("top.csv")]) == 0
assert open(p("A1_top.csv")).readline().strip() == "ID,Jaccard"
from {PKG} import read_pc_mat_module
res = read_pc_mat_module.query(p("m"), p("db"), p("q.txt"))
assert [r["id"] for r in res] == ["A1", "A5"] and len(res[0]["neighbor_ids"])
assert jaccard.main(["index", p("db"), "--device", "cpu"]) == 0
with open(p("h.txt")) as f, open(p("qh.txt"), "w") as g:
    g.write(f.readlines()[1])
for engine in ("f32", "int8"):
    assert jaccard.main(["search", p("db"), p("qh.txt"), "-j", "0.5",
                         "--engine", engine, "--device", "cpu"]) == 0
assert pairwise_comp.main(base_args + ["--output_folder", p("mh"),
                                       "--strategy", "1", "--hashes",
                                       p("h.txt")]) == 0
for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
    assert os.path.getsize(p("mh", "shard_0", f)) > 0
# the multi-device layer on a 2-slot CPU mesh: shard, indexes, top-k,
# pipeline step, multi-process helpers
from {PKG}.ann.distributed import DistributedIntExactIndex
from {PKG}.matrix.compute import compute_pairwise_shard
from {PKG}.parallel import multihost
from {PKG}.parallel.mesh import Mesh
from {PKG}.parallel.pairwise import distributed_topk
from {PKG}.parallel.pipeline import make_pipeline_step
mesh = Mesh(["cpu", "cpu"])
compute_pairwise_shard(p("db"), p("mm"), mesh=mesh, verbose=False,
                       device="cpu")
assert open(p("mm", "shard_0", "matrix.bin"), "rb").read() == \\
    open(p("m", "shard_0", "matrix.bin"), "rb").read()
idx = DistributedIntExactIndex.from_dbfolder(p("db"), mesh=mesh)
V = np.fromfile(p("db", "vectors.bin"), dtype=np.int32).reshape(48, 128)
assert idx.search(V[:2], 3)[1][:, 0].tolist() == [0, 1]
D, I = distributed_topk(mesh, np.eye(2, 8, dtype=np.float32),
                        np.eye(8, dtype=np.float32), 1)
assert I[:, 0].tolist() == [0, 1]
hi = rng.integers(0, 2**32, size=(4, 8), dtype=np.uint64).astype(np.uint32)
surv, _, _ = make_pipeline_step(mesh, 2048, 1, 2)(hi, hi, np.full(4, 8))
assert surv.tolist() == [1, 1, 1, 1]
assert multihost.host_shards(3) == [0, 1, 2]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "metagenome_vector_sketches_tpu"))
assert not loaded, loaded
print("STANDALONE_OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=t, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "STANDALONE_OK" in r.stdout


def test_port_modules_name_no_jax_package():
    """No module of the port imports the JAX package or benchmarks/."""
    import pkgutil
    pkg = importlib.import_module(PKG)
    for m in pkgutil.walk_packages(pkg.__path__, PKG + "."):
        path = importlib.util.find_spec(m.name).origin
        with open(path) as f:
            for ln in f:
                words = ln.split()
                assert not (words[:1] in (["from"], ["import"]) and len(words)
                            > 1 and words[1].split(".")[0] in (
                                "metagenome_vector_sketches_tpu",
                                "benchmarks")), (path, ln)


# ---------------------------------------------------------------------------
# parity of the copied host modules with their JAX-package originals
# ---------------------------------------------------------------------------

def _values(codec, rng):
    if codec == "ef":
        v = np.sort(rng.integers(0, 1 << 20, size=3000)).astype(np.uint64)
        return (v,), {"universe": int(v[-1]) + 1}
    v = rng.integers(0, 1 << 12, size=3000).astype(np.uint64)
    v[::7] = rng.integers(0, 1 << 40, size=len(v[::7]))
    return (v,), {}


def _codec_modules(impl):
    if impl == "dispatch":
        return j_codecs, t_codecs
    return (importlib.import_module(f"metagenome_vector_sketches_tpu.codecs."
                                    f"{impl}"),
            importlib.import_module(f"{PKG}.codecs.{impl}"))


def _case_codec(impl, codec, tmp_path, ref_toy_dir):
    jm, tm = _codec_modules(impl)
    args, kw = _values(codec, np.random.default_rng(len(impl) + len(codec)))
    jb = getattr(jm, f"{codec}_encode")(*args, **kw)
    tb = getattr(tm, f"{codec}_encode")(*args, **kw)
    assert bytes(jb) == bytes(tb)
    blob = b"\x07" * 24 + bytes(jb)        # decode at an offset
    # (values, consumed), plus the width for bitscompat's cv
    jd = getattr(jm, f"{codec}_decode")(blob, 24)
    td = getattr(tm, f"{codec}_decode")(blob, 24)
    assert len(jd) == len(td) and jd[2:] == td[2:]
    (jv, jn), (tv, tn) = jd[:2], td[:2]
    assert jn == tn == len(jb)
    np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))
    np.testing.assert_array_equal(np.asarray(tv), args[0])


def _db(tmp_path, int16):
    rng = np.random.default_rng(3)
    V = rng.integers(-40000, 40000, size=(50, 96)).astype(np.int32)
    names = [f"ACC{i:03d}" for i in range(50)]
    for side, mod in (("j", j_dbfolder), ("t", t_dbfolder)):
        mod.DbFolder.write(str(tmp_path / side), names, V, 96,
                           use_int16=int16)
    return V, names


def _case_dbfolder(int16, tmp_path, ref_toy_dir):
    _db(tmp_path, int16)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) and files
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f
    j, t = j_dbfolder.DbFolder(str(tmp_path / "j")), \
        t_dbfolder.DbFolder(str(tmp_path / "t"))
    assert j.names_and_norms()[0] == t.names_and_norms()[0]
    np.testing.assert_array_equal(j.names_and_norms()[1],
                                  t.names_and_norms()[1])
    np.testing.assert_array_equal(j.load_vectors(), t.load_vectors())


def _case_hashes(which, tmp_path, ref_toy_dir):
    path = str(ref_toy_dir / "all_hashes_toy.txt")
    if which == "query":
        jn, js = j_hashes.parse_query_hashes_file(path)
        tn, ts = t_hashes.parse_query_hashes_file(path)
        assert jn == tn
        pairs = list(zip(js, ts))
    else:
        j, t = j_hashes.parse_hashes_file(path), t_hashes.parse_hashes_file(
            path)
        assert [n for n, _ in j] == [n for n, _ in t]
        pairs = [(a, b) for (_, a), (_, b) in zip(j, t)]
    assert len(pairs) == 61
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)
    named = [(f"S{i}", set(b.tolist()[:50])) for i, (_, b) in
             enumerate(pairs[:5])]
    j_hashes.write_hashes_file(str(tmp_path / "j.txt"), named)
    t_hashes.write_hashes_file(str(tmp_path / "t.txt"), named)
    assert filecmp.cmp(tmp_path / "j.txt", tmp_path / "t.txt", shallow=False)


def _triples(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, size=900)
    c = rng.integers(0, n, size=900)
    keep = np.unique(r * n + c)
    r, c = keep // n, keep % n
    vals = rng.integers(1, 5000, size=len(r)).astype(np.int64) * 64
    ns = rng.uniform(2000.0, 9000.0, size=n)
    return r, c, vals, ns


UPSTREAM_N = 697_508  # accessions of the upstream server matrix


def _write_input(kind):
    """(rows, cols, raw dots, norms_sq) of one writer input: the distinct
    pairs of _triples in (row, col) order ("presorted"), shuffled,
    reversed, a single row, none, or ids next to the upstream's last,
    697,507, in a shuffled order."""
    r, c, v, ns = _triples(120, 5)
    if kind == "one_row":
        sel = r == r[len(r) // 2]
        r, c, v = r[sel], c[sel], v[sel]
    elif kind == "empty":
        r, c, v = r[:0], c[:0], v[:0]
    elif kind == "upstream_ids":
        r = r + (UPSTREAM_N - 120)
        c = c + (UPSTREAM_N - 120)
        ns = np.random.default_rng(6).uniform(2000.0, 9000.0,
                                              size=UPSTREAM_N)
    if kind in ("shuffled", "upstream_ids"):
        p = np.random.default_rng(8).permutation(len(r))
        r, c, v = r[p], c[p], v[p]
    elif kind == "reversed":
        r, c, v = r[::-1], c[::-1], v[::-1]
    return r, c, v, ns


WRITE_INPUTS = ("presorted", "shuffled", "reversed", "one_row", "empty",
                "upstream_ids")


def _case_write_shard(layout, kind, tmp_path, ref_toy_dir):
    """The port's writer, which orders its triples its own way, writes the
    JAX writer's three files byte for byte."""
    r, c, v, ns = _write_input(kind)
    j_writer.write_shard(str(tmp_path / "j"), r, c, v, ns, 64, layout=layout)
    t_writer.write_shard(str(tmp_path / "t"), r, c, v, ns, 64, layout=layout)
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f
    np.testing.assert_array_equal(
        t_writer.quantize_jaccard(v, r, c, ns, 64),
        j_writer.quantize_jaccard(v, r, c, ns, 64))


def _case_reader(layout, tmp_path, ref_toy_dir):
    n = 120
    for s, (lo, hi) in enumerate(((0, 60), (60, n))):
        r, c, v, ns = _triples(n, 7 + s)
        sel = (r >= lo) & (r < hi)
        j_writer.write_shard(str(tmp_path / "m" / f"shard_{s}"), r[sel],
                             c[sel], v[sel], ns, 64, layout=layout)
    j = j_reader.MatrixReader(str(tmp_path / "m")).decode_all_triples(n)
    t = t_reader.MatrixReader(str(tmp_path / "m")).decode_all_triples(n)
    assert len(j[0]) > 0
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    rows = [0, 5, 59, 60, 119]
    for a, b in zip(
            j_reader.MatrixReader(str(tmp_path / "m"))
            .load_neighbors_for_rows(rows, n),
            t_reader.MatrixReader(str(tmp_path / "m"))
            .load_neighbors_for_rows(rows, n)):
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def _case_faissio(metric, tmp_path, ref_toy_dir):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(37, 24)).astype(np.float32)
    m = getattr(j_faissio, metric)
    j_faissio.write_flat(str(tmp_path / "j.index"), X, m)
    t_faissio.write_flat(str(tmp_path / "t.index"), X, m)
    assert filecmp.cmp(tmp_path / "j.index", tmp_path / "t.index",
                       shallow=False)
    jx, jm = j_faissio.read_flat(str(tmp_path / "j.index"))
    tx, tm = t_faissio.read_flat(str(tmp_path / "j.index"))
    assert jm == tm == m
    np.testing.assert_array_equal(jx, tx)


def _case_query_engine(sliced, tmp_path, ref_toy_dir):
    n = 120
    r, c, v, ns = _triples(n, 13)
    j_writer.write_shard(str(tmp_path / "m" / "shard_0"), r, c, v, ns, 64)
    norms = np.sqrt(ns).astype(np.float32)
    names = [f"ACC{i:03d}" for i in range(n)]
    m = str(tmp_path / "m")
    if sliced:
        rows, cols = [3, 7, 50, 119], list(range(0, n, 3))
        np.testing.assert_array_equal(
            t_engine.query_sliced(m, rows, cols, n, norms),
            j_engine.query_sliced(m, rows, cols, n, norms))
        return
    qs = [0, 3, 7, 50, 119, -1, n + 2]
    jr, tr = j_engine.query(m, qs, norms, names), \
        t_engine.query(m, qs, norms, names)
    assert any(x.neighbor_ids for x in jr)
    for a, b in zip(jr, tr):
        assert a.self_id == b.self_id and a.neighbor_ids == b.neighbor_ids
        np.testing.assert_array_equal(a.jaccard_similarities,
                                      b.jaccard_similarities)


# the JAX package's JAX-free modules the port keeps as byte-for-byte copies
# under the same relative paths
COPIES = (
    "analysis/__init__.py", "analysis/accuracy.py", "analysis/clusters.py",
    "analysis/export.py", "analysis/interpret.py", "ann/faissio.py",
    "cli/query_ava_matrix.py", "cli/read_pc_mat.py", "codecs/__init__.py",
    "codecs/bitscompat.py", "codecs/native.py", "codecs/pyref.py",
    "io/dbfolder.py", "io/hashes.py", "io/sigzip.py", "matrix/legacy.py",
    "matrix/reader.py", "query/__init__.py",
    "query/engine.py", "query/outputs.py", "utils/__init__.py",
    "utils/log.py", "utils/npyio.py", "utils/zstdio.py")


def _case_copy(rel, tmp_path, ref_toy_dir):
    with open(os.path.join(REPO, "metagenome_vector_sketches_tpu", rel),
              "rb") as f, open(os.path.join(REPO, PKG, rel), "rb") as g:
        assert f.read() == g.read(), rel


CASES = {
    **{f"copy-{rel}": (_case_copy, (rel,)) for rel in COPIES},
    **{f"codec-{impl}-{codec}": (_case_codec, (impl, codec))
       for impl in ("pyref", "native", "bitscompat", "dispatch")
       for codec in ("cv", "rice", "ef")},
    "dbfolder-int32": (_case_dbfolder, (False,)),
    "dbfolder-int16": (_case_dbfolder, (True,)),
    "hashes-parse": (_case_hashes, ("parse",)),
    "hashes-query": (_case_hashes, ("query",)),
    **{f"write_shard-{layout}" + ("" if kind == "presorted" else f"-{kind}"):
       (_case_write_shard, (layout, kind))
       for layout in ("native", "bits") for kind in WRITE_INPUTS},
    "reader-native": (_case_reader, ("native",)),
    "reader-bits": (_case_reader, ("bits",)),
    "faissio-ip": (_case_faissio, ("METRIC_INNER_PRODUCT",)),
    "faissio-l2": (_case_faissio, ("METRIC_L2",)),
    "query_engine-topk": (_case_query_engine, (False,)),
    "query_engine-sliced": (_case_query_engine, (True,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_copy_matches_jax_original(case, tmp_path, ref_toy_dir):
    fn, args = CASES[case]
    fn(*args, tmp_path, ref_toy_dir)
