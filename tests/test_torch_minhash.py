"""The MinHash strategy (--strategy 1) of the port against the JAX package
on the CPU: exact intersections and triples (the shard engine's plain
kernels), shard and minhash_db bytes through the library and the CLI."""

import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.cli import pairwise_comp as j_pairwise  # noqa: E402
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.io.hashes import parse_hashes_file  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu.ops import minhash as jmh  # noqa: E402
from metagenome_vector_sketches_tpu.query import engine  # noqa: E402
from metagenome_vector_sketches_tpu_torch import _build  # noqa: E402
from metagenome_vector_sketches_tpu_torch.cli import pairwise_comp as t_pairwise  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import minhash as tmh  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
MDB_FILES = ("vector_norms.txt", "dimension.txt", "dtype.txt")


def _random_sets(seed=61, n=20):
    rng = np.random.default_rng(seed)
    return [rng.choice(5000, size=rng.integers(10, 400), replace=False)
            .astype(np.uint64) for _ in range(n)]


def _same(a, b):
    assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.mark.parametrize("rows", [7, 1 << 14])
def test_intersections_equal_jax(rows):
    """The shard engine's accumulator, ``rows`` rows a block, against the
    JAX package's dense universe Grams."""
    sets_ = _random_sets()
    got = tmh.pairwise_intersections(sets_, rows_per_block=rows,
                                     device="cpu")
    want = jmh.pairwise_intersections(sets_, chunk=512)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    py = [set(int(x) for x in s) for s in sets_]
    assert all(got[i, j] == len(py[i] & py[j])
               for i in range(20) for j in range(20))
    assert tmh.LAST_STAGES["blocks"] == (3 if rows == 7 else 1)
    assert _build.launch_counts()["gram"] == 0     # CPU: the plain version


@pytest.mark.parametrize("case", ["some_empty", "all_empty"])
def test_intersections_with_empty_sets_equal_jax(case):
    sets_ = _random_sets(seed=5, n=8)
    if case == "some_empty":
        sets_[0] = np.empty(0, dtype=np.uint64)
        sets_[5] = set()
    else:
        sets_ = [np.empty(0, dtype=np.uint64), set(), []]
    got = tmh.pairwise_intersections(sets_, rows_per_block=3, device="cpu")
    assert np.array_equal(got, jmh.pairwise_intersections(sets_, chunk=512))
    assert got.shape == (len(sets_), len(sets_))


@pytest.mark.parametrize("source", ["random", "toy"])
def test_triples_equal_jax(source, ref_toy_dir):
    if source == "random":
        sets_ = _random_sets(seed=7, n=30)
    else:
        sets_ = [h for _, h in parse_hashes_file(
            str(ref_toy_dir / "all_hashes_toy.txt"))]
    got = tmh.minhash_triples(sets_, device="cpu")
    want = jmh.minhash_triples(sets_)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_jaccard_equals_jax(ref_toy_dir):
    named = parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt"))[:12]
    sets_ = [h for _, h in named]
    jac, sizes = tmh.pairwise_jaccard_minhash(sets_, device="cpu")
    want_jac, want_sizes = jmh.pairwise_jaccard_minhash(sets_)
    assert np.array_equal(jac, want_jac) and np.array_equal(sizes, want_sizes)


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("with_db", [True, False])
def test_minhash_shard_bytes_equal_jax(tmp_path, ref_toy_dir, with_db,
                                       num_shards):
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    db = str(ref_toy_dir / "toy_db_256") if with_db else None
    for s in range(num_shards):
        jmc.compute_minhash_shard(hashes, str(tmp_path / "jax"), num_shards,
                                  s, db_folder=db, verbose=False)
        tmc.compute_minhash_shard(hashes, str(tmp_path / "port"), num_shards,
                                  s, db_folder=db, verbose=False,
                                  device="cpu")
        assert tmc.LAST_STAGES["mode"] == "minhash"
    for s in range(num_shards):
        for f in SHARD_FILES:
            _same(tmp_path / "jax" / f"shard_{s}" / f,
                  tmp_path / "port" / f"shard_{s}" / f)
    assert (tmp_path / "port" / "minhash_db").exists() == (not with_db)
    if not with_db:
        for f in MDB_FILES:
            _same(tmp_path / "jax" / "minhash_db" / f,
                  tmp_path / "port" / "minhash_db" / f)


def test_minhash_cli_equals_jax_cli(tmp_path, ref_toy_dir, capsys):
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    db_path = str(ref_toy_dir / "toy_db_256")
    base = ["--db", db_path, "--max_memory_gb", "1", "--num_threads", "1",
            "--num_shards", "1", "--shard_idx", "0", "--strategy", "1",
            "--hashes", hashes]
    assert j_pairwise.main(base + ["--output_folder",
                                   str(tmp_path / "jax")]) == 0
    out = str(tmp_path / "port")
    assert t_pairwise.main(base + ["--output_folder", out,
                                   "--device", "cpu"]) == 0
    capsys.readouterr()
    for f in SHARD_FILES:
        _same(tmp_path / "jax" / "shard_0" / f, tmp_path / "port" / "shard_0"
              / f)

    # the query check of tests/test_minhash.py on the port's shard
    db = DbFolder(db_path)
    identifiers, norms = db.names_and_norms_f32()
    results = engine.query(out, [10], norms, identifiers)
    assert results[0].neighbor_ids[0] == identifiers[10]
    assert results[0].jaccard_similarities[0] == np.float32(1.0)
    from metagenome_vector_sketches_tpu.matrix.reader import MatrixReader
    named = dict(parse_hashes_file(hashes))
    cols, q = MatrixReader(out).shard(0).decode_row(10)
    s10 = set(int(x) for x in named[identifiers[10]])
    assert len(cols)
    for c, qq in zip(cols, q):
        sc = set(int(x) for x in named[identifiers[int(c)]])
        true_j = len(s10 & sc) / len(s10 | sc)
        assert int(qq) == int(np.floor(true_j * 255 + 0.5))


def test_strategy1_without_hashes_returns_1(tmp_path, ref_toy_dir, capsys):
    rc = t_pairwise.main(["--db", str(ref_toy_dir / "toy_db_256"),
                          "--max_memory_gb", "1", "--num_threads", "1",
                          "--output_folder", str(tmp_path / "m"),
                          "--num_shards", "1", "--shard_idx", "0",
                          "--strategy", "1", "--device", "cpu"])
    assert rc == 1
    assert "--strategy 1 requires --hashes" in capsys.readouterr().err
    assert not (tmp_path / "m").exists()


def test_minhash_device_is_explicit(tmp_path, ref_toy_dir):
    hashes = str(ref_toy_dir / "all_hashes_toy.txt")
    with pytest.raises(TypeError):
        tmc.compute_minhash_shard(hashes, str(tmp_path / "m"))
    with pytest.raises(TypeError):
        tmh.pairwise_intersections(_random_sets())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmh.pairwise_intersections(_random_sets(), device="cuda")
