"""The port's beyond-memory streaming engine (plain PyTorch path on the
CPU, forced with device_budget_bytes=0) writes shard folders byte-identical
to the JAX package's streaming engine AND to the port's own resident
engine; the budget rule, the stale-sidecar check and kernel S's diagonal
offset (plain version)."""

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

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
MAX_ABS_FOR_L = {1: 100, 2: 3000, 3: 20000}


def _db(path, L, dtype, n=150, d=100, seed=0):
    rng = np.random.default_rng(seed + 10 * L)
    m = MAX_ABS_FOR_L[L]
    V = rng.integers(-m, m + 1, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[10:30] = np.clip(V[9] + rng.integers(-2, 3, size=(20, d)), -m, m)
    if n >= 110:
        V[100:110] = np.clip(V[3] + rng.integers(-2, 3, size=(10, d)), -m, m)
    V[0, 0] = m                                  # pins max_abs, hence L
    db = DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d,
                        use_int16=dtype == "int16")
    assert pm.pick_limbs(tmc.scan_max_abs(db)) == L
    return db


def _run(db, out, num_shards, tile):
    """JAX streaming, port streaming and port resident shards of db."""
    stages = []
    for s in range(num_shards):
        jmc.compute_pairwise_shard(db.path, str(out / "jax"), num_shards, s,
                                   tile_rows=tile, device_budget_bytes=0,
                                   verbose=False)
        assert jmc.LAST_STAGES["mode"] == "fused-streaming"
        tmc.compute_pairwise_shard(db.path, str(out / "stream"), num_shards,
                                   s, tile_rows=tile, device_budget_bytes=0,
                                   verbose=False, device="cpu")
        stages.append(dict(tmc.LAST_STAGES))
        tmc.compute_pairwise_shard(db.path, str(out / "resident"),
                                   num_shards, s, tile_rows=tile,
                                   verbose=False, device="cpu")
        assert tmc.LAST_STAGES["mode"] == "fused"
    for s in range(num_shards):
        for f in SHARD_FILES:
            got = out / "stream" / f"shard_{s}" / f
            for other in ("jax", "resident"):
                assert filecmp.cmp(got, out / other / f"shard_{s}" / f,
                                   shallow=False), (other, s, f)
    return stages


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_streaming_shards_equal_jax_and_resident(tmp_path, dtype, L,
                                                 num_shards):
    db = _db(tmp_path / "db", L, dtype)
    stages = _run(db, tmp_path, num_shards, tile=32)
    for st in stages:
        assert st["mode"] == "fused-streaming"
        assert st["windows"] == 3                 # 5 tiles, 2 per window
    # one shard: 3 row groups x 3 windows, every tile of the rectangle
    if num_shards == 1:
        assert stages[0]["row_groups"] == 3
        assert stages[0]["tiles_swept"] == 25
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(db.load_vectors().astype(np.int32),
                                 norms * norms, db.dimension,
                                 str(tmp_path / "stream"), 150, db.dtype)


def test_streaming_prefetch_crosses_row_groups(tmp_path, ref_toy_dir):
    """toy_db_256 at tile 16 and budget 0: several row groups x several
    windows, every window read again for each row group
    (tests/test_pairwise.py's streaming case)."""
    db = DbFolder(str(ref_toy_dir / "toy_db_256"))
    stages = _run(db, tmp_path, 1, tile=16)
    assert stages[0]["row_groups"] > 1 and stages[0]["windows"] > 1


def test_fused_streaming_oracle(tmp_path):
    """tests/test_fused_engine.py's streaming case on the port."""
    rng = np.random.default_rng(96)
    n, d = 160, 64
    V = rng.integers(-250, 251, size=(n, d)).astype(np.int32)
    V[30:40] = V[29] + rng.integers(-1, 2, size=(10, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), tile_rows=16,
                               device_budget_bytes=0, verbose=False,
                               device="cpu")
    assert tmc.LAST_STAGES["mode"] == "fused-streaming"
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(tmp_path / "m"), n)


def test_streaming_stale_max_component_raises(tmp_path):
    rng = np.random.default_rng(7)
    n, d = 24, 64
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
                                   device_budget_bytes=0, verbose=False,
                                   device="cpu")
    assert tmc.LAST_STAGES["mode"] == "fused-streaming"


def test_budget_rule_is_the_jax_rule(tmp_path):
    """Resident iff P * Npad * d <= device_budget_bytes."""
    db = _db(tmp_path / "db", 2, "int32")
    plane_bytes = pm.num_planes(2) * 160 * 100        # Npad = 5 x 32
    for budget, mode in ((plane_bytes, "fused"),
                         (plane_bytes - 1, "fused-streaming"),
                         (None, "fused")):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / str(budget)),
                                   tile_rows=32, device_budget_bytes=budget,
                                   verbose=False, device="cpu")
        assert tmc.LAST_STAGES["mode"] == mode


def test_engine_and_finalize_arguments(tmp_path):
    db = _db(tmp_path / "db", 1, "int32", n=40, d=64)
    with pytest.raises(ValueError, match="engine"):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                   engine="three_phase", device="cpu")
    with pytest.raises(ValueError, match="finalize"):
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"),
                                   finalize="gpu", device="cpu")
    for i, kw in enumerate(({}, dict(finalize="host"),
                            dict(finalize="device"),
                            dict(gate=True, tile_cols=7),
                            dict(engine="two_phase"),
                            dict(engine="two_phase", finalize="device"))):
        out = tmp_path / f"run{i}"
        tmc.compute_pairwise_shard(db.path, str(out), tile_rows=16,
                                   verbose=False, device="cpu", **kw)
        for f in SHARD_FILES:
            assert filecmp.cmp(out / "shard_0" / f,
                               tmp_path / "run0" / "shard_0" / f,
                               shallow=False)


@pytest.mark.parametrize("offset", [0, 40, -24])
def test_sweep_extract_plain_diag_offset(offset):
    """With two windows of one db (rows a.. and a + offset..), mask_self
    drops exactly the pairs of one global row: row == column + offset."""
    rng = np.random.default_rng(11)
    N, d, tile = 160, 64, 16
    V = rng.integers(-100, 101, size=(N, d)).astype(np.int32)
    V[60:100] = V[60] + rng.integers(-1, 2, size=(40, d))
    planes = torch.zeros((1, N, pw.pad_dim(d)), dtype=torch.int8)
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V), 1), 0)
    ns = np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
    thr = torch.from_numpy((ns / d).astype(np.float32))
    a = 48
    b = a + offset
    pi, ti = planes[:, a:a + 64].contiguous(), thr[a:a + 64].contiguous()
    pj, tj = planes[:, b:b + 64].contiguous(), thr[b:b + 64].contiguous()
    coords = np.array([(r, c) for r in range(4) for c in range(4)])
    cap = 1 << 14
    rc0, cnt0, tot0 = pw.sweep_extract(pi, ti, pj, tj, coords, tile, cap,
                                       False, d)
    rc1, cnt1, tot1 = pw.sweep_extract(pi, ti, pj, tj, coords, tile, cap,
                                       True, d, offset)
    every = {tuple(x) for x in rc0[:int(tot0)].tolist()}
    kept = {tuple(x) for x in rc1[:int(tot1)].tolist()}
    selfs = {(r, c) for r, c in every if a + r == b + c}
    assert len(selfs) == 64 - abs(offset)       # the windows' overlap
    assert kept == every - selfs
    assert int(cnt0.sum() - cnt1.sum()) == len(selfs)
