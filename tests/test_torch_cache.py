"""The pairwise engine's one-slot residency cache (the JAX package's
_RESIDENT / clear_device_cache) on the CPU: a second shard of the same db
re-uses the staged planes, anything in the key restages, the streaming
engine leaves the slot alone, a run on another db evicts it first, and
shards are byte-equal with and without a hit (and to the JAX engine's)."""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
TILE = 16


@pytest.fixture(autouse=True)
def _empty_slot():
    tmc.clear_device_cache()
    yield
    tmc.clear_device_cache()


def _db(path, seed=0, n=70, d=48):
    rng = np.random.default_rng(seed)
    V = rng.integers(-2000, 2001, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[10:25] = np.clip(V[9] + rng.integers(-3, 4, size=(15, d)), -2000, 2000)
    return DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d)


def _shard(db, out, shard_idx=0, num_shards=2, tile=TILE, **kw):
    tmc.compute_pairwise_shard(db.path, str(out), num_shards=num_shards,
                               shard_idx=shard_idx, tile_rows=tile,
                               verbose=False, device="cpu", **kw)
    return dict(tmc.LAST_STAGES)


def _planes():
    return tmc._RESIDENT["value"][0]


def _same_shard(a, b, s):
    for f in SHARD_FILES:
        assert filecmp.cmp(os.path.join(a, f"shard_{s}", f),
                           os.path.join(b, f"shard_{s}", f),
                           shallow=False), f


def test_second_shard_reuses_the_slot(tmp_path):
    db = _db(tmp_path / "db")
    first = _shard(db, tmp_path / "m", 0)
    planes = _planes()
    assert first["stage_h2d_ms"] > 0 and first["stage_decompose_ms"] > 0
    second = _shard(db, tmp_path / "m", 1)
    assert _planes() is planes
    assert second["mode"] == "fused"
    assert second["stage_h2d_ms"] == second["stage_decompose_ms"] == 0
    assert second["pairs_written"] > 0


@pytest.mark.parametrize("change", ["touch_vectors", "tile", "other_db",
                                    "clear"])
def test_key_change_restages(tmp_path, change):
    db = _db(tmp_path / "db")
    _shard(db, tmp_path / "m", 0)
    planes = _planes()
    tile = TILE
    if change == "touch_vectors":
        vb = os.path.join(db.path, "vectors.bin")
        os.utime(vb, (os.path.getmtime(vb) + 7, os.path.getmtime(vb) + 7))
    elif change == "tile":
        tile = 2 * TILE
    elif change == "other_db":
        db = _db(tmp_path / "db2", seed=1)
    else:
        tmc.clear_device_cache()
        assert tmc._RESIDENT == {}
    stages = _shard(db, tmp_path / "m2", 1, tile=tile)
    assert _planes() is not planes
    assert stages["stage_h2d_ms"] > 0
    assert tmc._RESIDENT["key"][0] == os.path.abspath(
        os.path.join(db.path, "vectors.bin"))


def test_shards_byte_equal_with_and_without_a_hit(tmp_path):
    """Shard 1 written from the slot equals shard 1 staged afresh, and
    both equal the JAX engine's shard 1."""
    db = _db(tmp_path / "db", seed=2)
    _shard(db, tmp_path / "hit", 0)
    assert _shard(db, tmp_path / "hit", 1)["stage_h2d_ms"] == 0
    tmc.clear_device_cache()
    assert _shard(db, tmp_path / "fresh", 1)["stage_h2d_ms"] > 0
    jmc.clear_device_cache()
    jmc.compute_pairwise_shard(db.path, str(tmp_path / "jax"), num_shards=2,
                               shard_idx=1, tile_rows=TILE, verbose=False)
    jmc.clear_device_cache()
    _same_shard(tmp_path / "hit", tmp_path / "fresh", 1)
    _same_shard(tmp_path / "hit", tmp_path / "jax", 1)


def test_streaming_leaves_the_slot_and_other_dbs_are_evicted(tmp_path):
    """The streaming engine neither reads nor fills the slot; a streaming
    run on another db evicts it before anything is staged."""
    db = _db(tmp_path / "db", seed=3)
    _shard(db, tmp_path / "m", 0)
    planes = _planes()
    stages = _shard(db, tmp_path / "s", 1, device_budget_bytes=0)
    assert stages["mode"] == "fused-streaming" and stages["stage_h2d_ms"] > 0
    assert _planes() is planes
    assert _shard(db, tmp_path / "m", 1)["stage_h2d_ms"] == 0
    _same_shard(tmp_path / "m", tmp_path / "s", 1)
    other = _db(tmp_path / "db2", seed=4)
    assert _shard(other, tmp_path / "o", 0,
                  device_budget_bytes=0)["mode"] == "fused-streaming"
    assert tmc._RESIDENT == {}


def test_stale_max_component_raises_on_a_fresh_slot(tmp_path):
    """The stale-sidecar guard of the resident stager still runs when the
    slot is filled (JAX test_round3_fixes.py); the slot stays empty."""
    rng = np.random.default_rng(8)
    n, d = 16, 32
    V = rng.integers(-3000, 3001, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    mc = os.path.join(db.path, "max_component.txt")
    with open(mc, "w") as f:
        f.write("5\n")
    vb = os.path.join(db.path, "vectors.bin")
    os.utime(mc, (os.path.getmtime(vb) + 5, os.path.getmtime(vb) + 5))
    with pytest.raises(ValueError, match="stale"):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=8,
                                   verbose=False, device="cpu")
    assert tmc._RESIDENT == {}
