"""The port's pairwise engine (plain PyTorch path on the CPU) writes shard
folders byte-identical to the JAX package's fused engine, on int32 and
int16 dbs, L = 1..3, one and three shards — and equal to the exact
oracle. Also: the exact-capacity rerun, the chunk halving, resume and the
empty shard."""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from helpers import assert_matrix_matches_oracle  # noqa: E402
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402
from torch_thresholds import assert_port_counts, jax_under_port_thresholds  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
MAX_ABS_FOR_L = {1: 100, 2: 3000, 3: 20000}
TILE = 32


def _db(path, L, dtype, n=150, d=100, seed=0):
    rng = np.random.default_rng(seed + 10 * L)
    m = MAX_ABS_FOR_L[L]
    V = rng.integers(-m, m + 1, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[10:30] = np.clip(V[9] + rng.integers(-2, 3, size=(20, d)), -m, m)
    V[0, 0] = m                                  # pins max_abs, hence L
    db = DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d,
                        use_int16=dtype == "int16")
    assert pm.pick_limbs(tmc.scan_max_abs(db)) == L
    return db


def _run_both(db, out, num_shards, **port_kw):
    stats = []
    for s in range(num_shards):
        jmc.compute_pairwise_shard(db.path, str(out / "jax"),
                                   num_shards=num_shards, shard_idx=s,
                                   tile_rows=TILE, verbose=False)
        tmc.compute_pairwise_shard(db.path, str(out / "port"),
                                   num_shards=num_shards, shard_idx=s,
                                   tile_rows=TILE, verbose=False,
                                   device="cpu", **port_kw)
        stats.append((dict(jmc.LAST_STAGES), dict(tmc.LAST_STAGES)))
    return stats


def _jax_port_thr_stats(db, out, num_shards):
    """The JAX engine's LAST_STAGES of each shard under the port's
    thresholds (torch_thresholds.jax_under_port_thresholds)."""
    stats = []
    with jax_under_port_thresholds(db.path):
        for s in range(num_shards):
            jmc.compute_pairwise_shard(db.path, str(out / "jax_port_thr"),
                                       num_shards=num_shards, shard_idx=s,
                                       tile_rows=TILE, verbose=False)
            stats.append(dict(jmc.LAST_STAGES))
    return stats


def _assert_same_bytes(out, num_shards):
    for s in range(num_shards):
        for f in SHARD_FILES:
            a = out / "jax" / f"shard_{s}" / f
            b = out / "port" / f"shard_{s}" / f
            assert filecmp.cmp(a, b, shallow=False), f"shard {s} {f}"


def _assert_oracle(db, out):
    _, norms = db.names_and_norms()
    V = db.load_vectors().astype(np.int32)
    assert_matrix_matches_oracle(V, norms * norms, db.dimension,
                                 str(out / "port"), len(V), db.dtype)


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_shards_byte_identical_to_jax_engine(tmp_path, dtype, L, num_shards):
    db = _db(tmp_path / "db", L, dtype)
    stats = _run_both(db, tmp_path, num_shards)
    _assert_same_bytes(tmp_path, num_shards)
    _assert_oracle(db, tmp_path)
    for (j, t), jp in zip(stats, _jax_port_thr_stats(db, tmp_path,
                                                     num_shards)):
        assert t["mode"] == "fused"
        # the fused engines count emitted pairs differently (the port's
        # kernel X counts the range filter's pairs on the card)
        assert_port_counts(t, j, jp, keys=("candidates",))
        # the port drops the JAX engine's per-round wall list (its rounds
        # are profiler spans) and its staging-site flag
        assert set(jmc.LAST_STAGES) - {"stage_decompose_mode",
                                       "dispatch_walls_ms"} <= set(t)


def test_exact_capacity_rerun(tmp_path, monkeypatch):
    """A survivor buffer far too small: each chunk is rerun once at its
    exact size, and the shard still equals the JAX engine's."""
    calls = []
    real = pw.sweep_extract

    def spy(*args):
        calls.append(args[6])                     # cap
        return real(*args)
    monkeypatch.setattr(pw, "sweep_extract", spy)
    monkeypatch.setattr(tmc, "SWEEP_CAP_START", 8)
    db = _db(tmp_path / "db", 2, "int32", seed=5)
    _run_both(db, tmp_path, 1)
    _assert_same_bytes(tmp_path, 1)
    assert calls[0] == 8 and len(calls) == 2 and calls[1] > 8


def test_chunk_halving_over_budget(tmp_path, monkeypatch):
    """When the exact size would break the buffer budget, the chunk of
    tiles is halved (down to one tile) instead; same shard."""
    chunks = []
    real = pw.sweep_extract

    def spy(*args):
        chunks.append(len(args[4]))               # tiles in the chunk
        return real(*args)
    monkeypatch.setattr(pw, "sweep_extract", spy)
    monkeypatch.setattr(tmc, "SWEEP_CAP_START", 1)
    monkeypatch.setattr(tmc, "CANDIDATE_BUDGET_BYTES", 64)
    db = _db(tmp_path / "db", 1, "int32", seed=6)
    _run_both(db, tmp_path, 1)
    _assert_same_bytes(tmp_path, 1)
    assert chunks[0] == 15 and min(chunks) == 1   # 5 x 5 triangle = 15 tiles


def test_empty_shard_resume_and_stale_max(tmp_path):
    db = _db(tmp_path / "db", 1, "int32", n=40, d=64)
    folder = tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                        num_shards=8, shard_idx=7,
                                        verbose=False, device="cpu")
    assert os.path.exists(os.path.join(folder, "neighbor_start.bin"))
    before = os.path.getmtime(os.path.join(folder, "matrix.bin"))
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), num_shards=8,
                               shard_idx=7, resume=True, verbose=False,
                               device="cpu")
    assert os.path.getmtime(os.path.join(folder, "matrix.bin")) == before
    with open(os.path.join(db.path, "max_component.txt"), "w") as f:
        f.write("3\n")                                  # stale, too small
    with pytest.raises(ValueError, match="stale"):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m2"),
                                   verbose=False, device="cpu")


def test_device_is_explicit_and_cuda_is_checked(tmp_path):
    db = _db(tmp_path / "db", 1, "int32", n=40, d=64)
    with pytest.raises(TypeError):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                       device="cuda")


def test_sweep_tile_rounds_up_on_cuda_only(capsys, monkeypatch):
    """Any --tile works on both devices: CUDA rounds it up to kernel S's
    128-row block (logged once per tile), the CPU keeps it; the shard does
    not depend on the tile (the writer lexsorts)."""
    monkeypatch.setattr(tmc, "_ROUNDED_TILES", set())
    for tile in (32, 100, 2048):
        assert tmc.sweep_tile(tile, "cpu") == tile
    assert [tmc.sweep_tile(t, "cuda") for t in (32, 32, 128, 300, 2048)] \
        == [128, 128, 128, 384, 2048]
    out = capsys.readouterr().out
    assert out.count("tile_rows=32 rounded up to 128") == 1
    assert "tile_rows=300 rounded up to 384" in out and "2048" not in out
