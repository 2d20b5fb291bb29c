"""The one stager of every engine (matrix.compute._upload_rows over
_FileRows) on the CPU: a row range of vectors.bin read with preadv into a
ring of host buffers, chunk by chunk, in the file's own dtype, copied and
split into limb planes. The staged planes equal decompose_limbs +
planes_update over the whole block, bit for bit, for int32 and int16 dbs
at L = 1, 2, 3, with chunks that do not divide N, chunks of one row, a db
of one row and reads that come back short; every such shard equals the
JAX engine's. A stale max_component.txt found in a later chunk raises and
leaves the residency slot empty; stage_bytes counts the file on a staging
and 0 on a hit; the streaming engines read the file only through the same
stager, and stage_bytes counts the rows they read. Then the benchmark's
readers of the two stage records."""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
TILE = 16
N, D = 70, 48
# the largest component of each limb count
MAX_ABS = {1: 100, 2: 3000, 3: 20000}
# STAGE_CHUNK_BYTES of each chunking: 16 int32 rows (32 int16 rows) a chunk,
# neither dividing N = 70; one row a chunk; a db of one row
CHUNKS = {"uneven": 16 * 4 * D, "one_row": 1, "n1": 16 * 4 * D,
          "short_reads": 16 * 4 * D}
# the JAX engine's shard folders, by (dtype, L, rows)
_JAX: dict = {}


@pytest.fixture(autouse=True)
def _empty_slot():
    tmc.clear_device_cache()
    yield
    tmc.clear_device_cache()


def _vectors(L, n, seed=0):
    rng = np.random.default_rng(seed + L)
    m = MAX_ABS[L]
    V = rng.integers(-m, m + 1, size=(n, D)).astype(np.int32)
    V[0, 0] = m
    if n > 25:
        V[1] = V[0]
        V[10:25] = np.clip(V[9] + rng.integers(-3, 4, size=(15, D)), -m, m)
    return V


def _db(path, dtype, L, n=N):
    V = _vectors(L, n)
    return DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, D,
                          use_int16=dtype == "int16"), V


def _shards(n):
    return 2 if n > 1 else 1


def _jax_shard(root, db, dtype, L, n):
    """The JAX engine's last shard of the db, written once per (dtype, L,
    rows) into the module's temporary folder."""
    key = (dtype, L, n)
    if key not in _JAX:
        out = str(root / f"jax_{dtype}_{L}_{n}")
        jmc.clear_device_cache()
        jmc.compute_pairwise_shard(db.path, out, num_shards=_shards(n),
                                   shard_idx=_shards(n) - 1, tile_rows=TILE,
                                   verbose=False)
        jmc.clear_device_cache()
        _JAX[key] = out
    return _JAX[key]


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return tmp_path_factory.mktemp("staging_jax")


def _short_preadv(monkeypatch, most=5):
    """Every preadv of the stager reads at most ``most`` bytes."""
    real = os.preadv
    calls = []

    def short(fd, buffers, offset):
        calls.append(offset)
        return real(fd, [memoryview(buffers[0])[:most]], offset)
    monkeypatch.setattr(os, "preadv", short)
    return calls


@pytest.mark.parametrize("chunking", sorted(CHUNKS))
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_staged_planes_are_bit_equal(tmp_path, jax_root, monkeypatch, dtype,
                                     L, chunking):
    n = 1 if chunking == "n1" else N
    db, V = _db(tmp_path / "db", dtype, L, n)
    monkeypatch.setattr(tmc, "STAGE_CHUNK_BYTES", CHUNKS[chunking])
    calls = _short_preadv(monkeypatch) if chunking == "short_reads" else []
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                               num_shards=_shards(n),
                               shard_idx=_shards(n) - 1, tile_rows=TILE,
                               verbose=False, device="cpu")
    monkeypatch.undo()
    stages = dict(tmc.LAST_STAGES)
    planes = tmc._RESIDENT["value"][0]
    assert pm.pick_limbs(int(np.abs(V).max())) == L
    want = torch.zeros_like(planes)
    pw.planes_update(want, pw.decompose_limbs(torch.from_numpy(V), L), 0)
    assert torch.equal(planes, want)
    assert stages["stage_bytes"] == os.path.getsize(
        os.path.join(db.path, "vectors.bin"))
    if chunking == "short_reads":
        assert len(calls) >= stages["stage_bytes"] // 5
    out = _jax_shard(jax_root, db, dtype, L, n)
    for f in SHARD_FILES:
        assert filecmp.cmp(os.path.join(out, f"shard_{_shards(n) - 1}", f),
                           tmp_path / "m" / f"shard_{_shards(n) - 1}" / f,
                           shallow=False), f


def test_a_file_that_ends_early_raises(tmp_path, monkeypatch):
    """A vectors.bin shorter than its rows, found when it is opened or by a
    read that returns nothing, raises; the slot stays empty."""
    db, _ = _db(tmp_path / "db", "int32", 2)
    with pytest.raises(ValueError, match="fewer than"):
        tmc._FileRows(db, N + 1, D)
    monkeypatch.setattr(tmc, "STAGE_CHUNK_BYTES", CHUNKS["uneven"])
    real = os.preadv
    monkeypatch.setattr(os, "preadv", lambda fd, bufs, off: 0 if off
                        >= 40 * 4 * D else real(fd, bufs, off))
    with pytest.raises(ValueError, match="ends at byte"):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                   tile_rows=TILE, verbose=False,
                                   device="cpu")
    assert tmc._RESIDENT == {}


def test_stale_max_component_in_a_later_chunk_raises(tmp_path, monkeypatch):
    """The first chunk holds components up to 50 and max_component.txt says
    50; a later chunk holds 3000: the staging raises the stale-sidecar
    error with the file's true largest component, and fills no slot."""
    V = _vectors(2, N)
    V[:40] = np.clip(V[:40], -50, 50)
    V[60, 3] = -3000
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(N)],
                        V, D)
    mc = os.path.join(db.path, "max_component.txt")
    with open(mc, "w") as f:
        f.write("50\n")
    vb = os.path.join(db.path, "vectors.bin")
    os.utime(mc, (os.path.getmtime(vb) + 5, os.path.getmtime(vb) + 5))
    monkeypatch.setattr(tmc, "STAGE_CHUNK_BYTES", CHUNKS["uneven"])
    with pytest.raises(ValueError, match=r"max_component.txt \(50\) is "
                       r"stale: vectors.bin holds \|component\| up to 3000"):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                   tile_rows=TILE, verbose=False,
                                   device="cpu")
    assert tmc._RESIDENT == {}


@pytest.mark.parametrize("engine", ["fused", "two_phase"])
def test_stage_bytes_counts_the_file_and_nothing_on_a_hit(tmp_path,
                                                          monkeypatch,
                                                          engine):
    db, _ = _db(tmp_path / "db", "int16", 2)
    size = os.path.getsize(os.path.join(db.path, "vectors.bin"))
    monkeypatch.setattr(tmc, "STAGE_CHUNK_BYTES", CHUNKS["uneven"])
    kw = dict(num_shards=2, tile_rows=TILE, verbose=False, device="cpu",
              engine=engine)
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), shard_idx=0,
                               **kw)
    first = dict(tmc.LAST_STAGES)
    assert first["stage_bytes"] == size
    assert first["stage_read_ms"] > 0 and first["stage_wait_ms"] > 0
    assert first["stage_h2d_ms"] > 0 and first["stage_decompose_ms"] > 0
    assert first["stage_read_ms"] + first["stage_h2d_ms"] \
        + first["stage_decompose_ms"] <= first["stage_ms"] * 1.5
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), shard_idx=1,
                               **kw)
    second = dict(tmc.LAST_STAGES)
    for key in ("stage_bytes", "stage_read_ms", "stage_wait_ms",
                "stage_h2d_ms", "stage_decompose_ms"):
        assert second[key] == 0, key


def test_streaming_counts_its_windows_bytes(tmp_path):
    """The streaming engine reads every window from vectors.bin, and its row
    group: stage_bytes is at least the file, and its reads are timed."""
    db, _ = _db(tmp_path / "db", "int32", 2)
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "s"), num_shards=2,
                               tile_rows=TILE, device_budget_bytes=0,
                               verbose=False, device="cpu")
    st = tmc.LAST_STAGES
    assert st["mode"] == "fused-streaming"
    assert st["stage_bytes"] >= os.path.getsize(
        os.path.join(db.path, "vectors.bin"))
    assert st["stage_read_ms"] > 0 and st["stage_h2d_ms"] > 0


@pytest.mark.parametrize("engine", ["fused", "two_phase"])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_streaming_engines_read_only_through_the_stager(tmp_path,
                                                        monkeypatch, dtype,
                                                        engine):
    """Both streaming engines read vectors.bin only through _FileRows.fill,
    into host buffers of the file's own dtype (no memmap and no
    load_vectors of the file; the two-phase finalize on the planes), and
    stage_bytes is the rows read x d x the file's itemsize: 2 B a
    component for an int16 db."""
    db, _ = _db(tmp_path / "db", dtype, 2)
    monkeypatch.setattr(tmc, "STAGE_CHUNK_BYTES", CHUNKS["uneven"])
    rows_read = []
    real = tmc._FileRows.fill

    def spy(self, out, lo, hi):
        assert out.dtype == np.dtype(dtype) and out.shape == (hi - lo, D)
        rows_read.append(hi - lo)
        return real(self, out, lo, hi)

    def other_read(*args, **kwargs):
        raise AssertionError("vectors.bin read outside the stager")
    monkeypatch.setattr(tmc._FileRows, "fill", spy)
    monkeypatch.setattr(np, "memmap", other_read)
    monkeypatch.setattr(DbFolder, "load_vectors", other_read)
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), num_shards=2,
                               shard_idx=1, tile_rows=TILE,
                               device_budget_bytes=0, verbose=False,
                               device="cpu", engine=engine,
                               finalize="device")
    monkeypatch.undo()
    st = tmc.LAST_STAGES
    assert st["mode"] == f"{engine}-streaming"
    itemsize = 2 if dtype == "int16" else 4
    # every window of the file, and the shard's 35 rows once a window
    # (two-phase, a row tile at a time) or once (fused, one row group)
    assert sum(rows_read) >= N + 35
    assert st["stage_bytes"] == sum(rows_read) * D * itemsize
    assert st["stage_read_ms"] > 0


@pytest.mark.parametrize("metric, key", [("shard.stage_read_ms",
                                          "stage_read_ms"),
                                         ("shard.stage_bytes",
                                          "stage_bytes")])
def test_benchmark_readers_of_the_stage_records(metric, key):
    """The mean of the shard calls' record; nothing where the program has
    no such key (a build before the pipelined stager)."""
    from portbench import run, spec
    from portbench.trace import Trace

    def ctx(calls):
        return run.Context(calls, 10.0, 1.0, {}, Trace([], 0.0, 1e7))
    read = spec.reader(metric)
    calls = [{"kind": "shard", "stages": {key: 100.0, "stage_ms": 5.0}},
             {"kind": "shard", "stages": {key: 300.0, "stage_ms": 7.0}},
             {"kind": "search", "stages": {key: 9e9}}]
    assert read(ctx(calls)) == 200.0
    assert read(ctx([{"kind": "shard", "stages": {"stage_ms": 5.0}}])) \
        is None
    assert read(ctx([])) is None
