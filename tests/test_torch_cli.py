"""The README walkthrough (sketch -> pairwise_comp shards -> query_pc_mat
top-k and sliced) through the port's command-line tools on the CPU, with
every output file equal to the JAX package's tools'; the port never imports
jax; and the tools refuse to run without CUDA unless told --device cpu."""

import filecmp
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.cli import (  # noqa: E402
    pairwise_comp as j_pairwise, project_everything as j_project,
    query_pc_mat as j_query, standalone_projection as j_standalone)
from metagenome_vector_sketches_tpu_torch.cli import (  # noqa: E402
    pairwise_comp as t_pairwise, project_everything as t_project,
    query_pc_mat as t_query, standalone_projection as t_standalone)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DB_FILES = ("vectors.bin", "vector_norms.txt", "dimension.txt", "dtype.txt",
            "max_component.txt")
SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")


def _same(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.mark.parametrize("int16", [False, True])
def test_walkthrough_matches_jax_tools(tmp_path, ref_toy_dir, int16,
                                       capsys):
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    extra = ["--int16"] if int16 else []
    out = {}
    for side, project, pairwise, query, dev in (
            ("jax", j_project, j_pairwise, j_query, ["--mesh_devices", "1"]),
            ("port", t_project, t_pairwise, t_query, ["--device", "cpu"])):
        root = tmp_path / side
        db, mat = str(root / "db"), str(root / "mat")
        assert project.main(["sketch", hashes, db, "-d", "256", *extra]
                            + (["--device", "cpu"] if side == "port"
                               else [])) == 0
        for s in range(2):
            assert pairwise.main(
                ["--db", db, "--max_memory_gb", "1", "--num_threads", "1",
                 "--output_folder", mat, "--num_shards", "2",
                 "--shard_idx", str(s), "--tile", "32", *dev]) == 0
        with open(os.path.join(db, "vector_norms.txt")) as f:
            names = [ln.split()[0] for ln in f if ln.strip()]
        (root / "q.txt").write_text("\n".join(names[:12:3]) + "\n")
        (root / "rows.txt").write_text("\n".join(names[:9]) + "\n")
        (root / "cols.txt").write_text("\n".join(names[::4]) + "\n")
        assert query.main(["--matrix", mat, "--db", db, "--query_file",
                           str(root / "q.txt"), "--top", "5",
                           "--write_to_file", str(root / "top.csv")]) == 0
        assert query.main(["--matrix", mat, "--db", db, "--row_file",
                           str(root / "rows.txt"), "--col_file",
                           str(root / "cols.txt"), "--write_to_file",
                           str(root / "sliced.tsv")]) == 0
        out[side] = (root, names)
    capsys.readouterr()
    (jr, names), (tr, _) = out["jax"], out["port"]
    for f in DB_FILES:
        _same(jr / "db" / f, tr / "db" / f)
    for s in range(2):
        for f in SHARD_FILES:
            _same(jr / "mat" / f"shard_{s}" / f, tr / "mat" / f"shard_{s}" / f)
    for name in names[:12:3]:
        _same(jr / f"{name}_top.csv", tr / f"{name}_top.csv")
    _same(jr / "sliced.tsv", tr / "sliced.tsv")


def test_standalone_projection_matches_jax_tool(tmp_path, capsys):
    lines = ["1 2 3 18446744073709551615", "", "42 9223372036854775808 7"]
    path = tmp_path / "h.txt"
    path.write_text("\n".join(lines) + "\n")
    assert j_standalone.main([str(path), "100"]) == 0
    want = capsys.readouterr().out
    assert t_standalone.main([str(path), "100", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("given", ["nothing", "hashes_file"])
def test_standalone_projection_usage_equals_jax_tool(tmp_path, capsys,
                                                     given):
    """Missing arguments: the JAX tool's usage line on stderr and exit code
    1, with or without the port's --device."""
    argv = [] if given == "nothing" else [str(tmp_path / "h.txt")]
    assert j_standalone.main(list(argv)) == 1
    want = capsys.readouterr()
    assert want.err.startswith("Usage: standalone_projection") and \
        not want.out
    for port_argv in (argv, argv + ["--device", "cpu"]):
        assert t_standalone.main(port_argv) == 1
        assert capsys.readouterr() == want


@pytest.mark.parametrize("name", ["host", "device", "auto"])
def test_sketch_takes_jax_device_names(tmp_path, ref_toy_dir, name):
    """sketch --device takes the JAX tool's names: host is the CPU and
    writes the JAX run's db (whose vectors.bin is toy_db_256's); device
    and auto are the card, so without one they raise the default's error
    and write nothing."""
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    argv = ["sketch", hashes, str(tmp_path / "port"), "-d", "256"]
    if name != "host" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError) as got:
            t_project.main(argv + ["--device", name])
        with pytest.raises(RuntimeError) as default:
            t_project.main(argv)
        assert str(got.value) == str(default.value)
        assert "cuda" in str(got.value)
        assert not (tmp_path / "port").exists()
        return
    assert j_project.main(["sketch", hashes, str(tmp_path / "jax"), "-d",
                           "256", "--device", name]) == 0
    assert t_project.main(argv + ["--device", name]) == 0
    for f in DB_FILES:
        _same(tmp_path / "jax" / f, tmp_path / "port" / f)
    _same(ref_toy_dir / "toy_db_256" / "vectors.bin",
          tmp_path / "port" / "vectors.bin")


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter runs the port's CPU path end to end (sketch,
    shard, query) and never loads jax nor any module of the JAX
    package."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from metagenome_vector_sketches_tpu_torch.io.ingest import sketch
from metagenome_vector_sketches_tpu_torch.matrix.compute import (
    compute_pairwise_shard)
from metagenome_vector_sketches_tpu_torch.cli import (
    pairwise_comp, project_everything, query_pc_mat, standalone_projection)
from metagenome_vector_sketches_tpu_torch.query import engine as query_engine
rng = np.random.default_rng(0)
with open({str(tmp_path / 'h.txt')!r}, "w") as f:
    for i in range(40):
        hs = rng.integers(0, 2**63, size=50, dtype=np.uint64)
        f.write(f"A{{i}}: " + " ".join(map(str, hs.tolist())) + "\\n")
db = sketch({str(tmp_path / 'h.txt')!r}, {str(tmp_path / 'db')!r}, 128,
            device="cpu", verbose=False)
compute_pairwise_shard(db.path, {str(tmp_path / 'm')!r}, tile_rows=16,
                       verbose=False, device="cpu")
compute_pairwise_shard(db.path, {str(tmp_path / 'ms')!r}, tile_rows=16,
                       device_budget_bytes=0, verbose=False, device="cpu")
assert pairwise_comp.main(["--db", db.path, "--max_memory_gb", "1",
                           "--num_threads", "1", "--output_folder",
                           {str(tmp_path / 'mh')!r}, "--num_shards", "1",
                           "--shard_idx", "0", "--strategy", "1", "--hashes",
                           {str(tmp_path / 'h.txt')!r}, "--device", "cpu"]) == 0
names, norms = db.names_and_norms_f32()
res = query_engine.query({str(tmp_path / 'm')!r}, [0, 1], norms, names)
assert res[0].self_id == "A0"
from metagenome_vector_sketches_tpu_torch.ann import search, validate
from metagenome_vector_sketches_tpu_torch.cli import jaccard
assert jaccard.main(["index", db.path, "--device", "cpu"]) == 0
with open({str(tmp_path / 'h.txt')!r}) as f, \\
        open({str(tmp_path / 'q.txt')!r}, "w") as g:
    g.write(f.readline())
for engine in ("f32", "int8"):
    hits = search.search_index(db.path, {str(tmp_path / 'q.txt')!r}, 0.5,
                               verbose=False, engine=engine, device="cpu")
    assert hits[0][:2] == (0, "A0"), hits
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
jax_pkg = [m for m in sys.modules
           if m.split(".")[0] == "metagenome_vector_sketches_tpu"]
assert not jax_pkg, sorted(jax_pkg)
print("NO_JAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_JAX_OK" in r.stdout


def test_tools_refuse_to_run_without_cuda(tmp_path, ref_toy_dir):
    """The default device is cuda: with no GPU the tools raise instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    with pytest.raises(RuntimeError, match="cuda"):
        t_project.main(["sketch", hashes, str(tmp_path / "db"), "-d", "64"])
    assert not (tmp_path / "db").exists()
    assert t_project.main(["sketch", hashes, str(tmp_path / "db"), "-d",
                           "64", "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="cuda"):
        t_pairwise.main(["--db", str(tmp_path / "db"), "--max_memory_gb",
                         "1", "--num_threads", "1", "--output_folder",
                         str(tmp_path / "m"), "--num_shards", "1",
                         "--shard_idx", "0"])
    assert not (tmp_path / "m").exists()


@pytest.mark.parametrize("flags", [["--mesh_devices", "4"]])
def test_pairwise_comp_refuses_unported_engines(tmp_path, ref_toy_dir,
                                                flags):
    """--mesh_devices above the local device count raises ValueError in
    both tools, before any shard is written (the port's CPU has one
    device, the JAX tests' mesh eight)."""
    n = int(flags[1])
    for main, extra, want, have in (
            (t_pairwise.main, ["--device", "cpu"], n, 1),
            (j_pairwise.main, [], 8 * n, 8)):
        args = ["--db", str(ref_toy_dir / "toy_db_256"), "--max_memory_gb",
                "1", "--num_threads", "1", "--output_folder",
                str(tmp_path / "m"), "--num_shards", "1", "--shard_idx", "0",
                "--mesh_devices", str(want), *extra]
        with pytest.raises(ValueError,
                           match=f"need {want} local devices, have {have}"):
            main(args)
    assert not (tmp_path / "m").exists()


@pytest.mark.parametrize("flags", [["--finalize", "device"],
                                   ["--finalize", "host"],
                                   ["--gate_sparse_tiles"]])
def test_pairwise_comp_accepts_finalize_and_gate(tmp_path, ref_toy_dir,
                                                 flags):
    """The JAX CLI writes the default shard under --finalize and
    --gate_sparse_tiles; so does the port (it refused both before)."""
    db = str(ref_toy_dir / "toy_db_256")
    for name, extra in (("default", []), ("flags", flags)):
        assert t_pairwise.main(
            ["--db", db, "--max_memory_gb", "1", "--num_threads", "1",
             "--output_folder", str(tmp_path / name), "--num_shards", "1",
             "--shard_idx", "0", "--tile", "32", "--device", "cpu",
             *extra]) == 0
    for f in SHARD_FILES:
        _same(tmp_path / "default" / "shard_0" / f,
              tmp_path / "flags" / "shard_0" / f)
