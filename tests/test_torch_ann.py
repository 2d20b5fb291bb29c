"""The port's ANN serving path against the JAX package's on the CPU: the
faiss.index bytes, the f32 / bf16_rescore flat engine, the adaptive
expanding search (both routes), search_index with all three engines,
validate, and the jaccard command-line tool."""

import filecmp
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.ann import flat_index as jfi  # noqa: E402
from metagenome_vector_sketches_tpu.ann import int_index as jii  # noqa: E402
from metagenome_vector_sketches_tpu.ann import search as jsearch  # noqa: E402
from metagenome_vector_sketches_tpu.ann import validate as jvalidate  # noqa: E402
from metagenome_vector_sketches_tpu.cli import jaccard as j_jaccard  # noqa: E402
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.io.hashes import parse_hashes_file  # noqa: E402
from metagenome_vector_sketches_tpu_torch import state  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import flat_index as tfi  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import int_index as tii  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import search as tsearch  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import validate as tvalidate  # noqa: E402
from metagenome_vector_sketches_tpu_torch.cli import jaccard as t_jaccard  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_index_caches():
    jsearch.clear_index_cache()
    tsearch.clear_index_cache()
    yield
    jsearch.clear_index_cache()
    tsearch.clear_index_cache()


@pytest.mark.parametrize("db", ["toy_db_256", "toy_db_2048",
                                "toy_db_2048_i16"])
def test_index_vectors_bytes_equal_jax(tmp_path, ref_toy_dir, db):
    for side in ("jax", "port"):
        shutil.copytree(str(ref_toy_dir / db), tmp_path / side)
    a = jfi.index_vectors(str(tmp_path / "jax"), verbose=False)
    b = tfi.index_vectors(str(tmp_path / "port"), verbose=False)
    assert filecmp.cmp(a, b, shallow=False)
    idx = tfi.FlatIPIndex.load(b, device="cpu")
    assert np.array_equal(idx.vectors, jfi.FlatIPIndex.load(a).vectors)


def _near_tie_ok(Dj, Ij, It, k, tol=1e-6):
    """I equal wherever the scores around the mismatch are not near-ties."""
    for b in range(Ij.shape[0]):
        for r in np.nonzero(Ij[b] != It[b])[0]:
            gaps = np.abs(Dj[b, max(r - 1, 0):r + 2] - Dj[b, r])
            assert np.sort(gaps)[1] < tol, (b, r)


@pytest.mark.parametrize("precision,chunk,k", [
    ("f32", 128, 10), ("f32", 1000, 700), ("bf16_rescore", 128, 10),
    ("bf16_rescore", 97, 40)])
def test_flat_index_equals_jax(precision, chunk, k):
    rng = np.random.default_rng(21)
    V = jfi.normalize_l2(rng.normal(size=(500, 64)).astype(np.float32))
    V[7] = V[3]                                        # exact tie
    Q = jfi.normalize_l2(rng.normal(size=(7, 64)).astype(np.float32))
    Q[0] = V[3]
    Dj, Ij = jfi.FlatIPIndex(V, chunk_rows=chunk,
                             precision=precision).search(Q, k)
    port = state.flat_index_from_reference(V, device="cpu", chunk_rows=chunk,
                                           precision=precision)
    Dt, It = port.search(Q, k)
    assert Dt.shape == Dj.shape == (7, k) and It.dtype == np.int32
    np.testing.assert_allclose(Dt, Dj, rtol=0, atol=1e-6)
    _near_tie_ok(Dj, Ij, It, k)
    assert It[0, :2].tolist() == [3, 7]
    if k > 500:
        assert (It[:, 500:] == -1).all() and (Dt[:, 500:] == 0).all()


def test_flat_index_from_device_chunks():
    rng = np.random.default_rng(22)
    V = tfi.normalize_l2(rng.normal(size=(300, 32)).astype(np.float32))
    Q = V[:5] + np.float32(0.01)
    host = tfi.FlatIPIndex(V, chunk_rows=64, device="cpu")
    chunks = [(s, torch.from_numpy(V[s:s + 64])) for s in range(0, 300, 64)]
    dev = tfi.FlatIPIndex.from_device_chunks(chunks, 32)
    assert len(chunks) == 5
    Dh, Ih = host.search(Q, 12)
    Dd, Id = dev.search(Q, 12)
    assert np.array_equal(Ih, Id) and np.array_equal(Dh, Dd)
    bf = tfi.FlatIPIndex.from_device_chunks(chunks, 32, store="bf16")
    assert len(chunks) == 0 and bf.precision == "bf16_rescore"
    Db, Ib = bf.search(Q, 12)
    assert (Ib[:, 0] == np.arange(5)).all()
    Vb = torch.from_numpy(V).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(Db, np.take_along_axis(
        Q @ Vb.T, Ib.astype(np.int64), 1), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="device chunks"):
        dev.save("unused")


def _expansion_db():
    """tests/test_ann.py:52-75's data: 180 near-identical rows force the
    expansion past k = 50."""
    rng = np.random.default_rng(24)
    d, n_close = 64, 180
    base = rng.normal(size=d).astype(np.float32)
    close = base[None, :] + 0.01 * rng.normal(size=(n_close, d)) \
        .astype(np.float32)
    far = rng.normal(size=(300, d)).astype(np.float32)
    V = np.concatenate([close, far])
    norms = np.linalg.norm(V, axis=1).astype(np.float64)
    return V, norms, base


def test_adaptive_search_f32_equals_jax():
    V, norms, base = _expansion_db()
    Q = np.stack([base, V[200], V[5]]).astype(np.float64)
    out = {}
    for side, mod, index in (
            ("jax", jsearch, jfi.FlatIPIndex(jfi.normalize_l2(V),
                                             chunk_rows=128)),
            ("port", tsearch, tfi.FlatIPIndex(tfi.normalize_l2(V),
                                              chunk_rows=128, device="cpu"))):
        hits, qn = mod.adaptive_search(index, Q, j=0.3, verbose=False,
                                       db_norms=norms)
        out[side] = (hits, qn, dict(mod.LAST_ADAPTIVE_STAGES))
    (hj, qj, sj), (ht, qt, st) = out["jax"], out["port"]
    # the same hits; float32 sums in another order may swap near-tied ranks
    assert st["rounds"] == sj["rounds"] >= 2
    gj = {(q, i): x for q, i, x in hj}
    assert len(ht) == len(hj) and {(q, i) for q, i, _ in ht} == set(gj)
    for q, i, x in ht:
        assert abs(x - gj[(q, i)]) <= 1e-6
    assert np.array_equal(qt, qj)
    names = [f"A{i}" for i in range(len(V))]
    rj = jsearch.rescore(hj, qj, names, norms, 0.3, verbose=False)
    rt = tsearch.rescore(ht, qt, names, norms, 0.3, verbose=False)
    assert {(q, n) for q, n, _ in rt} == {(q, n) for q, n, _ in rj}
    assert sum(1 for q, n, _ in rt if q == 0) >= 178


def test_adaptive_search_int8_equals_jax():
    """The int8 device route: planted group of 120 near-duplicates (two
    rounds), float64-exact emitted ips identical to the JAX engine's."""
    rng = np.random.default_rng(25)
    d = 64
    base = rng.integers(-400, 401, size=d)
    V = rng.integers(-400, 401, size=(300, d))
    V[:120] = base + rng.integers(-3, 4, size=(120, d))
    V = V.astype(np.int32)
    norms = np.linalg.norm(V.astype(np.float64), axis=1) / np.sqrt(d)
    Qi = np.stack([base, V[250], V[7]]).astype(np.int32)
    Qf = Qi.astype(np.float64) / np.sqrt(d)
    out = {}
    for side, mod, index in (
            ("jax", jsearch, jii.IntExactIndex(V, chunk_rows=64)),
            ("port", tsearch, tii.IntExactIndex(V, chunk_rows=64,
                                                device="cpu"))):
        hits, qn = mod.adaptive_search(index, Qf, j=0.2, verbose=False,
                                       db_norms=norms, queries_int=Qi)
        out[side] = (hits, dict(mod.LAST_ADAPTIVE_STAGES))
    (hj, sj), (ht, st) = out["jax"], out["port"]
    assert st["rounds"] == sj["rounds"] >= 2
    assert ht == hj
    assert sum(1 for q, _, _ in ht if q == 0) >= 120


@pytest.fixture(scope="module")
def toy_2048(tmp_path_factory, ref_toy_dir):
    """toy_db_2048 with its faiss.index, and a query file of 8 of its own
    accessions (plus one taken twice)."""
    root = tmp_path_factory.mktemp("anntoy")
    db = root / "db"
    shutil.copytree(str(ref_toy_dir / "toy_db_2048"), db)
    jfi.index_vectors(str(db), verbose=False)
    named = dict(parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt")))
    names, _ = DbFolder(str(db)).names_and_norms()
    qf = root / "q.txt"
    with open(qf, "w") as f:
        for n in names[:40:5] + [names[3]]:
            f.write(f"{n}: " + " ".join(str(h) for h in named[n]) + "\n")
    return str(db) + "/", str(qf)


# f32: XLA's float32 dot and torch's sum the 2048 products in other orders;
# on a self hit XLA's ip is 3.3e-6 off the float64 value (torch's 2.4e-7),
# and the Jaccard near 1 doubles an ip error — hence 1e-5, not 1e-6
@pytest.mark.parametrize("engine,tol", [("f32", 1e-5), ("int8", 1e-12),
                                        ("int8_approx", 1e-12)])
def test_search_index_equals_jax(toy_2048, engine, tol):
    db, qf = toy_2048
    rj = jsearch.search_index(db, qf, 0.05, verbose=False, engine=engine)
    rt = tsearch.search_index(db, qf, 0.05, verbose=False, engine=engine,
                              device="cpu")
    assert len(rt) > 9
    assert {(q, n) for q, n, _ in rt} == {(q, n) for q, n, _ in rj}
    gj = {(q, n): x for q, n, x in rj}
    for q, n, x in rt:
        assert abs(x - gj[(q, n)]) <= tol, (q, n, x, gj[(q, n)])


def test_search_index_refuses_mesh(toy_2048):
    db, qf = toy_2048
    with pytest.raises(ValueError, match="mesh_devices"):
        tsearch.search_index(db, qf, 0.1, verbose=False, mesh_devices=8,
                             device="cpu")


def test_validate_equals_jax(toy_2048, ref_toy_dir):
    db, _ = toy_2048
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    rj = jvalidate.validate(db, hashes, n_samples=6, j=0.05, seed=7,
                            verbose=False, engine="int8")
    rt = tvalidate.validate(db, hashes, n_samples=6, j=0.05, seed=7,
                            verbose=False, engine="int8", device="cpu")
    assert len(rt) >= 6
    assert [r[:2] + r[3:] for r in rt] == [r[:2] + r[3:] for r in rj]
    np.testing.assert_allclose([r[2] for r in rt], [r[2] for r in rj],
                               rtol=0, atol=1e-12)


def _neighbor_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("Query ", "  Neighbor ")) or " vs " in ln]


@pytest.mark.parametrize("engine", ["f32", "int8"])
def test_jaccard_cli_equals_jax(tmp_path, ref_toy_dir, capsys, engine):
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    out = {}
    for side, main, dev in (("jax", j_jaccard.main, []),
                            ("port", t_jaccard.main, ["--device", "cpu"])):
        db = tmp_path / side
        shutil.copytree(str(ref_toy_dir / "toy_db_2048"), db)
        with open(hashes) as f, open(tmp_path / "q.txt", "w") as g:
            g.writelines(f.readlines()[:4])
        capsys.readouterr()
        assert main(["index", str(db), *dev]) == 0
        assert main(["search", str(db), str(tmp_path / "q.txt"), "-j",
                     "0.05", "--engine", engine, *dev]) == 0
        assert main(["test", str(db), hashes, "-n", "5", "--seed", "3",
                     "--engine", engine, *dev]) == 0
        out[side] = _neighbor_lines(capsys.readouterr().out)
    assert filecmp.cmp(tmp_path / "jax" / "faiss.index",
                       tmp_path / "port" / "faiss.index", shallow=False)
    assert len(out["port"]) > 10
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("command", ["search", "test"])
def test_jaccard_mesh_devices_zero_equals_jax(tmp_path, ref_toy_dir, capsys,
                                              command):
    """--mesh_devices 0 means every local device, which is one on the CPU:
    the port's search and test print what its --mesh_devices 1 prints and
    what the JAX tool prints with --mesh_devices 0."""
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    with open(hashes) as f, open(tmp_path / "q.txt", "w") as g:
        g.writelines(f.readlines()[:3])
    out = {}
    for side, main, dev, meshes in (
            ("jax", j_jaccard.main, [], ("0",)),
            ("port", t_jaccard.main, ["--device", "cpu"], ("0", "1"))):
        db = tmp_path / side
        shutil.copytree(str(ref_toy_dir / "toy_db_256"), db)
        assert main(["index", str(db), *dev]) == 0
        args = ["search", str(db), str(tmp_path / "q.txt")] \
            if command == "search" else ["test", str(db), hashes, "-n", "5",
                                         "--seed", "3"]
        for md in meshes:
            capsys.readouterr()
            assert main([*args, "-j", "0.1", "--mesh_devices", md, *dev]) == 0
            out[side, md] = _neighbor_lines(capsys.readouterr().out)
    assert len(out["port", "0"]) > 3
    assert out["port", "0"] == out["port", "1"] == out["jax", "0"]


def test_jaccard_cli_refuses_mesh_and_missing_cuda(tmp_path, ref_toy_dir):
    """More --mesh_devices than local devices raise ValueError in both
    tools (the port's CPU has one device, the JAX tests' mesh eight)."""
    with open(ref_toy_dir / "all_hashes_toy.txt") as f, \
            open(tmp_path / "q.txt", "w") as g:
        g.writelines(f.readlines()[:2])
    db = str(ref_toy_dir / "toy_db_256")
    for main, n, have, dev in ((t_jaccard.main, 8, 1, ["--device", "cpu"]),
                               (j_jaccard.main, 9, 8, [])):
        with pytest.raises(ValueError,
                           match=f"need {n} local devices, have {have}"):
            main(["search", db, str(tmp_path / "q.txt"), "--mesh_devices",
                  str(n), *dev])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_jaccard.main(["index", str(tmp_path)])
