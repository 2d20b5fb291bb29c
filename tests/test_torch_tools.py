"""The port's query, legacy and analysis tools against the JAX package's
originals on the same seeded inputs: the zstd reader, the legacy matrix
formats, query_ava_matrix, read_pc_mat and the pybind drop-in, the analysis
helpers, the profiling helpers and the numpy pairwise oracle. The JAX
package's own tests of these modules (test_analysis, test_compat,
test_round2_fixes, test_round3_fixes, test_native_hardening,
test_cli_hardening) are mirrored here as cases on the port's modules."""

import io
import os
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import read_pc_mat_module as j_rpc  # noqa: E402
from metagenome_vector_sketches_tpu.analysis import (  # noqa: E402
    accuracy as j_accuracy, clusters as j_clusters, export as j_export,
    interpret as j_interpret)
from metagenome_vector_sketches_tpu.cli import (  # noqa: E402
    query_ava_matrix as j_query_ava, read_pc_mat as j_read_pc_mat)
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as j_compute  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import legacy as j_legacy  # noqa: E402
from metagenome_vector_sketches_tpu.utils import zstdio as j_zstdio  # noqa: E402
from metagenome_vector_sketches_tpu_torch import (  # noqa: E402
    read_pc_mat_module as t_rpc)
from metagenome_vector_sketches_tpu_torch.analysis import (  # noqa: E402
    accuracy as t_accuracy, clusters as t_clusters, export as t_export,
    interpret as t_interpret)
from metagenome_vector_sketches_tpu_torch.cli import (  # noqa: E402
    query_ava_matrix as t_query_ava, read_pc_mat as t_read_pc_mat)
from metagenome_vector_sketches_tpu_torch.matrix import compute as t_compute  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import legacy as t_legacy  # noqa: E402
from metagenome_vector_sketches_tpu_torch.utils import profiling as t_profiling  # noqa: E402
from metagenome_vector_sketches_tpu_torch.utils import zstdio as t_zstdio  # noqa: E402

FORMATS = ("prev", "ef", "rice", "sorted")


@pytest.fixture(scope="module")
def toy_shard(tmp_path_factory, ref_toy_dir):
    """The port's shard of toy_db_256 (CPU path) and a work folder."""
    base = tmp_path_factory.mktemp("tools")
    db_path = str(ref_toy_dir / "toy_db_256")
    matrix = str(base / "matrix")
    t_compute.compute_pairwise_shard(db_path, matrix, tile_rows=64,
                                     verbose=False, device="cpu")
    t_compute.clear_device_cache()
    return db_path, matrix, base


def _same_dicts(a, b):
    assert isinstance(b, dict) and a.keys() == b.keys()
    for r in a:
        for x, y in zip(a[r], b[r]):
            np.testing.assert_array_equal(x, y)


def _legacy_inputs(fmt, seed=21, n=6, d=256):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 5)
    cols = np.tile(np.sort(rng.choice(50, size=5, replace=False)), n)
    vals = rng.integers(1, 10**6, size=len(rows))
    extra = (rng.uniform(500, 5000, size=50),) if fmt == "sorted" else ()
    return rows, cols, vals, extra, d


def _write_legacy(mod, fmt, folder, rows, cols, vals, extra, d, **kw):
    write = getattr(mod, f"write_legacy_{fmt}")
    if fmt == "prev":
        write(folder, rows, cols, vals, d)
    else:
        write(folder, rows, cols, vals, *extra, d, **kw)
    return getattr(mod, f"read_legacy_{fmt}")


def _same_folders(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


# ---------------------------------------------------------------------------
# legacy formats and the zstd reader
# ---------------------------------------------------------------------------

# format A (prev) is raw int32: it has no codec layout
@pytest.mark.parametrize("fmt,layout", [("prev", "native")] + [
    (f, layout) for f in FORMATS[1:] for layout in ("native", "bits")])
def test_legacy_writers_and_readers_equal_jax(tmp_path, fmt, layout):
    """Both packages write the same bytes and read back the same rows (the
    JAX round-trip tests' inputs, test_analysis.py and
    test_round2_fixes.py)."""
    args = _legacy_inputs(fmt)
    kw = {} if fmt == "prev" else {"layout": layout}
    j_read = _write_legacy(j_legacy, fmt, str(tmp_path / "j"), *args, **kw)
    t_read = _write_legacy(t_legacy, fmt, str(tmp_path / "t"), *args, **kw)
    _same_folders(tmp_path / "j", tmp_path / "t")
    want = j_read(str(tmp_path / "j"))
    assert len(want) == 6
    _same_dicts(want, t_read(str(tmp_path / "j")))


@pytest.mark.parametrize("fmt", FORMATS)
def test_legacy_readers_accept_zst_folders(tmp_path, fmt):
    """Historical shards left as <file>.zst read in-process, in both
    packages, to the rows of the plain folder (test_round2_fixes.py)."""
    args = _legacy_inputs(fmt)
    folder = str(tmp_path / fmt)
    t_read = _write_legacy(t_legacy, fmt, folder, *args)
    plain = t_read(folder)
    t_legacy.compress_legacy_folder(folder)
    assert all(name.endswith(".zst") for name in os.listdir(folder))
    _same_dicts(plain, t_read(folder))
    _same_dicts(plain, getattr(j_legacy, f"read_legacy_{fmt}")(folder))


@pytest.mark.parametrize("fmt", FORMATS)
def test_legacy_readers_reject_corrupt_files_like_jax(tmp_path, fmt):
    """Corrupt or truncated legacy files: each reader raises an ordinary
    exception (never a MemoryError) or decodes, and the port's reader does
    the same as the JAX one on every mutation (test_round3_fixes.py)."""
    rng = np.random.default_rng(47)
    folder = str(tmp_path / fmt)
    t_read = _write_legacy(t_legacy, fmt, folder, *_legacy_inputs(fmt, 47))
    j_read = getattr(j_legacy, f"read_legacy_{fmt}")

    def outcome(read):
        try:
            return read(folder)
        except MemoryError:
            raise AssertionError(f"unbounded allocation from corrupt {fmt}")
        except Exception as e:
            return type(e)

    mutations = 0
    for fname in sorted(os.listdir(folder)):
        path = os.path.join(folder, fname)
        with open(path, "rb") as f:
            data = f.read()
        for mut in range(6):
            bb = bytearray(data)
            if mut % 2 == 0:
                bb = bb[:int(rng.integers(0, len(bb)))]
            else:
                for _ in range(int(rng.integers(1, 4))):
                    bb[int(rng.integers(0, len(bb)))] = int(rng.integers(0,
                                                                         256))
            with open(path, "wb") as f:
                f.write(bytes(bb))
            want, got = outcome(j_read), outcome(t_read)
            if isinstance(want, dict):
                _same_dicts(want, got)
            else:
                assert got is want
            mutations += 1
            with open(path, "wb") as f:
                f.write(data)
    assert mutations >= 12


def test_zstdio_backends_equal_jax(monkeypatch):
    """Round trips through the port's module, frames of either package read
    by the other, and the ctypes libzstd back end cross-checked
    (test_round2_fixes.py)."""
    data = bytes(range(256)) * 1000 + b"tail"
    assert t_zstdio.available()
    frame = t_zstdio.compress(data)
    assert frame == j_zstdio.compress(data)
    assert t_zstdio.decompress(frame) == data
    assert t_zstdio.decompress(j_zstdio.compress(data, 9)) == data
    lib = t_zstdio._load_libzstd()
    if lib is None:
        return
    monkeypatch.setattr(t_zstdio, "_backend", ("libzstd", lib))
    native_frame = t_zstdio.compress(data)
    assert t_zstdio.decompress(native_frame) == data
    monkeypatch.setattr(t_zstdio, "_backend", None)
    assert t_zstdio.decompress(native_frame) == data
    assert j_zstdio.decompress(native_frame) == data


def test_zstdio_unknown_content_size_frame():
    """Streamed frames (no content size in the header) go through the
    streaming path of both back ends (test_round2_fixes.py)."""
    zstandard = pytest.importorskip("zstandard")
    data = b"payload-" * 5000
    cobj = zstandard.ZstdCompressor().compressobj()
    frame = cobj.compress(data) + cobj.flush()
    assert t_zstdio.decompress(frame) == j_zstdio.decompress(frame) == data
    lib = t_zstdio._load_libzstd()
    if lib is not None:
        assert t_zstdio._decompress_libzstd(lib, frame) == data


def test_zstd_truncated_raises():
    """A frame cut mid-way raises 'truncated' in the active back end and in
    libzstd's, multi-frame input reads whole (test_native_hardening.py)."""
    data = b"hello world " * 100000
    z = t_zstdio.compress(data)
    z2 = t_zstdio.compress(b"A" * 1000) + t_zstdio.compress(b"B" * 1000)
    assert t_zstdio.decompress(z) == data
    assert t_zstdio.decompress(z2) == b"A" * 1000 + b"B" * 1000
    decoders = [t_zstdio.decompress]
    lib = t_zstdio._load_libzstd()
    if lib is not None:
        decoders.append(lambda b: t_zstdio._decompress_libzstd(lib, b))
    for dec in decoders:
        assert dec(z2) == b"A" * 1000 + b"B" * 1000
        for bad in (z[: len(z) // 2], z2[:-5]):
            with pytest.raises(ValueError, match="truncated"):
                dec(bad)
            with pytest.raises(ValueError, match="truncated"):
                j_zstdio.decompress(bad)


# ---------------------------------------------------------------------------
# query_ava_matrix, read_pc_mat, the pybind drop-in
# ---------------------------------------------------------------------------

def _small_legacy(tmp_path, seed, n, d, with_norms=False):
    """A db folder and a legacy 'prev' matrix of it (two neighbours a row;
    test_round2/round3_fixes.py)."""
    rng = np.random.default_rng(seed)
    V = rng.integers(-50, 51, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    rows = np.repeat(np.arange(n), 2)
    cols = np.tile(np.array([0, 1]), n)
    vals = np.abs(V[rows] @ np.ones(d, dtype=np.int64)) + d
    mdir = str(tmp_path / "m")
    t_legacy.write_legacy_prev(mdir, rows, cols, vals, d)
    if with_norms:
        shutil.copy(os.path.join(db.path, "vector_norms.txt"),
                    os.path.join(mdir, "vector_norms.txt"))
    return db, mdir


def _both(main_j, main_t, argv, capsys, monkeypatch=None, stdin=None):
    """(rc, stdout) of the JAX tool and of the port's on the same argv."""
    out = []
    for main in (main_j, main_t):
        if stdin is not None:
            monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        rc = main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_query_ava_matrix_cli_equals_jax(toy_shard, ref_toy_dir, capsys,
                                         tmp_path):
    """The legacy query tool on the exact oracle's triples of toy_db_256
    (test_compat.py): same exit code and output as the JAX tool."""
    db_path, _, _ = toy_shard
    db = DbFolder(db_path)
    _, norms = db.names_and_norms()
    vecs = db.load_vectors().astype(np.int32)
    r, c, v = t_compute.compute_pairwise_oracle(vecs, norms * norms,
                                                db.dimension)
    legacy_dir = str(tmp_path / "legacy")
    t_legacy.write_legacy_prev(legacy_dir, r, c, v, db.dimension)
    want, got = _both(j_query_ava.main, t_query_ava.main,
                      ["--matrix", legacy_dir, "--db", db_path,
                       "--query_ids", "10", "3", "--top", "3"], capsys)
    assert got == want and got[0] == 0
    assert "Query: 10" in got[1] and "jaccard=" in got[1]


@pytest.mark.parametrize("case", ["query_ids", "stdin", "compressed",
                                  "out_of_range", "no_queries"])
def test_query_ava_matrix_flag_surface_equals_jax(tmp_path, capsys,
                                                  monkeypatch, case):
    """The reference's flag surface (--matrix_folder, --stdin, norms read
    from the matrix folder), an as-left .zst folder, out-of-range query and
    neighbour ids, no query at all: the port's tool prints what the JAX
    tool prints (test_round2/round3_fixes.py, test_cli_hardening.py)."""
    db, mdir = _small_legacy(tmp_path, 7, 8, 32, with_norms=True)
    argv, stdin = ["--matrix_folder", mdir], None
    if case == "query_ids":
        argv += ["--query_ids", "3"]
    elif case == "stdin":
        argv, stdin = argv + ["--stdin"], "S2\n5\n"
    elif case == "compressed":
        t_legacy.compress_legacy_folder(mdir)
        argv = ["--matrix", mdir, "--db", db.path, "--query_ids", "3",
                "--top", "2"]
    elif case == "out_of_range":
        # row 0 gains neighbour column 99, beyond the 8-row norms file
        t_legacy.write_legacy_prev(mdir, np.array([0, 0]),
                                   np.array([1, 99]), np.array([80, 80]), 32)
        argv += ["--query_ids", "0", "999"]
    want, got = _both(j_query_ava.main, t_query_ava.main, argv, capsys,
                      monkeypatch, stdin)
    assert got == want
    if case == "no_queries":
        assert got[0] == 1
        return
    assert got[0] == 0 and "Query: " in got[1]
    if case == "out_of_range":
        assert "Query: 999 (UNKNOWN)" in got[1] and "UNKNOWN" in got[1]


def _names_files(base, names):
    q, r, c = base / "q.txt", base / "r.txt", base / "c.txt"
    q.write_text(f"{names[0]}\n{names[5]}\n")
    r.write_text("\n".join(names[:3]) + "\n")
    c.write_text("\n".join(names[:4]) + "\n")
    return str(q), str(r), str(c)


def test_read_pc_mat_module_equals_root_shim(toy_shard):
    """The port's pybind drop-in answers like the repo-root one (which runs
    the JAX package's query engine) on the port's shard: same keys, ids,
    neighbours and Jaccards (test_compat.py)."""
    db_path, matrix, base = toy_shard
    names, _ = DbFolder(db_path).names_and_norms()
    qf, rf, cf = _names_files(base, names)
    got, want = t_rpc.query(matrix, db_path, qf), j_rpc.query(matrix,
                                                              db_path, qf)
    assert len(got) == len(want) == 2 and got[0]["id"] == names[0]
    for a, b in zip(got, want):
        assert set(a) == {"id", "neighbor_ids", "jaccard_similarities"}
        assert a["id"] == b["id"]
        assert isinstance(a["jaccard_similarities"], np.ndarray)
        np.testing.assert_array_equal(a["neighbor_ids"], b["neighbor_ids"])
        np.testing.assert_array_equal(a["jaccard_similarities"],
                                      b["jaccard_similarities"])
    sliced = t_rpc.query_sliced(matrix, db_path, rf, cf)
    assert sliced == j_rpc.query_sliced(matrix, db_path, rf, cf)
    assert sliced["row-list"] == names[:3] and sliced["col-list"] == names[:4]
    assert len(sliced["jac-dict"][names[0]]) == 4


def _untimed(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith("Query completed in")]


@pytest.mark.parametrize("mode", ["query_file", "sliced", "bad_flags"])
def test_read_pc_mat_cli_equals_jax(toy_shard, capsys, mode):
    """read_pc_mat's top-10 printout and pandas slice equal the JAX tool's
    (apart from the line with the query's wall time); a bad flag mix exits
    2 in both."""
    db_path, matrix, base = toy_shard
    names, _ = DbFolder(db_path).names_and_norms()
    qf, rf, cf = _names_files(base, names)
    argv = ["--matrix", matrix, "--db", db_path]
    if mode == "query_file":
        argv += ["--query_file", qf]
    elif mode == "sliced":
        pytest.importorskip("pandas")
        argv += ["--row_file", rf, "--col_file", cf]
    else:
        argv += ["--query_file", qf, "--row_file", rf]
        for main in (j_read_pc_mat.main, t_read_pc_mat.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
        err = capsys.readouterr().err
        assert err.count("Cannot combine --query_file") == 2
        return
    out = []
    for main in (j_read_pc_mat.main, t_read_pc_mat.main):
        assert main(argv) == 0
        out.append(_untimed(capsys.readouterr().out))
    assert out[0] == out[1] and len(out[1]) > 4


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def _case_simulate_cell(tmp_path, ref_toy_dir):
    kw = dict(dimension=2048, sampling=1000, n_trials=200)
    j = j_accuracy.simulate_cell(1_000_000, 1_000_000, 0.2,
                                 rng=np.random.default_rng(0), **kw)
    t = t_accuracy.simulate_cell(1_000_000, 1_000_000, 0.2,
                                 rng=np.random.default_rng(0), **kw)
    assert t == j and t["rmse_rp"] < 0.03 and t["rmse_fmh"] < 0.03
    p1, p5, p50, p95, p99 = t["percentiles"]
    assert p1 <= p5 <= p50 <= p95 <= p99


def _case_simulate_cell_infeasible(tmp_path, ref_toy_dir):
    for mod in (j_accuracy, t_accuracy):
        assert mod.simulate_cell(100, 1_000_000_000, 0.5, n_trials=10) is None
    assert t_accuracy.simulate_cell(10_000, 10_000, 0.5, n_trials=10) == \
        j_accuracy.simulate_cell(10_000, 10_000, 0.5, n_trials=10)


def _case_small_trials(tmp_path, ref_toy_dir):
    kw = dict(dimension=64, sampling=10, n_trials=10)
    t = t_accuracy.simulate_cell(1000, 1000, 0.5, **kw)
    assert t == j_accuracy.simulate_cell(1000, 1000, 0.5, **kw)
    p1, p5, p50, p95, pmax = t["percentiles"]
    assert p1 <= p5 <= p50 <= p95 <= pmax


def _case_error_vs_dimension(tmp_path, ref_toy_dir):
    kw = dict(n_elements=2000, n_sets=400, dimensions=(256, 4096),
              verbose=False)
    curve = t_accuracy.error_vs_dimension(**kw)
    assert curve == j_accuracy.error_vs_dimension(**kw)
    assert curve[0][1] > curve[1][1]


def _case_grid_and_pickle(tmp_path, ref_toy_dir):
    kw = dict(sizes=[10_000, 100_000], jaccards=[0, 0.5], n_trials=50,
              verbose=False)
    j = j_accuracy.compute_error_for_all_points_in_space(
        out_pickle=str(tmp_path / "j.pkl"), **kw)
    t = t_accuracy.compute_error_for_all_points_in_space(
        out_pickle=str(tmp_path / "t.pkl"), **kw)
    assert t == j and len(t) > 0
    with open(tmp_path / "t.pkl", "rb") as f:
        assert pickle.load(f) == t


def _case_clusters_pca(tmp_path, ref_toy_dir):
    folder = str(ref_toy_dir / "toy_db_256")
    vectors, names = t_clusters.load_vectors(folder)
    jv, jn = j_clusters.load_vectors(folder)
    np.testing.assert_array_equal(vectors, jv)
    np.testing.assert_array_equal(names, jn)
    assert len(vectors) == len(names) > 0
    pca = t_clusters.make_pca()
    res = pca.fit_transform(vectors)
    assert res.shape[0] == len(vectors)
    assert pca.explained_variance_ratio_[0] >= pca.explained_variance_ratio_[1]
    j_pca = j_clusters.make_pca()
    np.testing.assert_array_equal(res, j_pca.fit_transform(jv))
    np.testing.assert_array_equal(pca.explained_variance_ratio_,
                                  j_pca.explained_variance_ratio_)


def _case_clusters_int16_overlay(tmp_path, ref_toy_dir):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(1)
    V = rng.integers(-300, 301, size=(5, 32)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db16"), [f"S{i}" for i in range(5)],
                        V, 32, use_int16=True)
    vecs, names = t_clusters.load_vectors(db.path)
    assert vecs.dtype == np.int16 and vecs.shape[1] == 32
    np.testing.assert_array_equal(vecs, j_clusters.load_vectors(db.path)[0])
    V[:2].astype(np.int16).tofile(os.path.join(db.path, "big_vectors.bin"))
    t_clusters.plot_clusters(db.path, show=False,
                             save=str(tmp_path / "plot.png"))
    fig = plt.gcf()
    labels = [x.get_text() for x in (fig.legends[0].texts if fig.legends
                                     else fig.axes[0].get_legend().texts)]
    assert "big_vectors" in labels and os.path.getsize(tmp_path / "plot.png")
    plt.close("all")


def _case_interpret_and_export(tmp_path, ref_toy_dir):
    db_path = str(ref_toy_dir / "toy_db_256")
    out = str(tmp_path / "m")
    t_compute.compute_pairwise_shard(db_path, out, tile_rows=64,
                                     verbose=False, device="cpu")
    t_compute.clear_device_cache()
    total = DbFolder(db_path).num_vectors
    rows, counts = t_interpret.neighbor_count_histogram(out, total)
    jr, jc = j_interpret.neighbor_count_histogram(out, total)
    np.testing.assert_array_equal(rows, jr)
    np.testing.assert_array_equal(counts, jc)
    assert len(rows) > 0 and np.all(counts >= 1)
    t_npz = np.load(t_export.export_npz(out, total, str(tmp_path / "t")))
    j_npz = np.load(j_export.export_npz(out, total, str(tmp_path / "j.npz")))
    assert set(t_npz.files) == {"row", "col", "data"}
    assert len(t_npz["row"]) == counts.sum()
    for k in t_npz.files:
        np.testing.assert_array_equal(t_npz[k], j_npz[k])


ANALYSIS_CASES = {
    "simulate_cell": _case_simulate_cell,
    "simulate_cell_infeasible": _case_simulate_cell_infeasible,
    "simulate_cell_small_trials": _case_small_trials,
    "error_vs_dimension": _case_error_vs_dimension,
    "grid_and_pickle": _case_grid_and_pickle,
    "clusters_pca": _case_clusters_pca,
    "clusters_int16_overlay": _case_clusters_int16_overlay,
    "interpret_and_export": _case_interpret_and_export,
}


@pytest.mark.parametrize("case", sorted(ANALYSIS_CASES))
def test_analysis_equals_jax(case, tmp_path, ref_toy_dir):
    ANALYSIS_CASES[case](tmp_path, ref_toy_dir)


def test_interpret_rows_equal_jax(tmp_path, capsys):
    """print_row_jaccards on a legacy matrix with an unknown neighbour and a
    missing row prints what the JAX function prints
    (test_cli_hardening.py)."""
    rng = np.random.default_rng(0)
    V = rng.integers(-5, 6, size=(3, 16)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), ["S0", "S1", "S2"], V, 16)
    mdir = str(tmp_path / "legacy")
    t_legacy.write_legacy_prev(mdir, np.array([1, 1]), np.array([0, 42]),
                               np.array([64, 64]), 16)
    out = []
    for mod in (j_interpret, t_interpret):
        for row in (1, 77):
            mod.print_row_jaccards(mdir, db.path, row=row, legacy=True)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "UNKNOWN" in out[1] and "not found" in out[1]


# ---------------------------------------------------------------------------
# the numpy oracle and the profiling helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_range", [None, (5, 37)])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_pairwise_oracle_equals_jax(dtype, row_range):
    """compute_pairwise_oracle of the port returns the JAX function's
    triples on seeded int32 and int16 inputs, whole or on a row range;
    negative dots exercise the int32 truncating division."""
    rng = np.random.default_rng(5 if dtype == "int32" else 6)
    n, d = 48, 64
    hi = 30000 if dtype == "int16" else 3000
    V = rng.integers(-hi, hi + 1, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[2] = -V[3]
    V[10:20] = np.clip(V[9] + rng.integers(-40, 41, size=(10, d)), -hi, hi)
    ns = np.einsum("ij,ij->i", V.astype(np.float64),
                   V.astype(np.float64)) / d
    got = t_compute.compute_pairwise_oracle(V, ns, d, dtype, row_range)
    want = j_compute.compute_pairwise_oracle(V, ns, d, dtype, row_range)
    assert len(got[0]) > n // 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_stage_timers_and_device_trace(tmp_path):
    """stage adds each block's wall to its key and, inside a profiler, is
    the block's span; device_trace writes a torch.profiler trace under its
    folder on the CPU, which names the ops it ran and the stage's span."""
    record = {}
    for _ in range(2):
        with t_profiling.stage("mvs.test.outside", record, "a_ms"):
            pass
    assert set(record) == {"a_ms"} and record["a_ms"] >= 0
    x = torch.arange(64, dtype=torch.float32)
    with t_profiling.device_trace(str(tmp_path / "trace")):
        with t_profiling.stage("mvs.test.inside", record, "b_ms") as t0:
            y = torch.mm(x[None, :], x[:, None])
    assert float(y) == float((x * x).sum())
    assert record["b_ms"] > 0 and t0 > 0
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        text = f.read()
    assert "aten::mm" in text and "mvs.test.inside" in text
    assert "mvs.test.outside" not in text
