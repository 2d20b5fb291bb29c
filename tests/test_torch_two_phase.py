"""The port's two-phase pairwise engine (plain PyTorch path on the CPU)
against the JAX package's two-phase engine on the same dbs: shard folders
byte-identical to the JAX engine's and to the port's fused engine, for
int32 (P = 3) and int16 (P = 6) dbs, finalize host and device, resident
and streaming, one and three shards, tiles 8, 12 (tile^2 % 32 != 0, where
both packages route the fused engine to the two-phase one), 16 and 32;
meshes of 2 and 8 CPU slots; LAST_STAGES pairs_written equal to JAX's,
candidates and emitted equal to the JAX engine's under the port's per-row
thresholds and no more than its own; the exact-dot helpers and the engine's
counts sweep against the JAX functions (the Pallas kernel in interpret
mode); the residency slot shared with the fused engine; the advisory
counts. Tolerance: exact everywhere (bytes and integers)."""

import contextlib
import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu.ops import pairwise as jpw  # noqa: E402
from metagenome_vector_sketches_tpu.ops.pallas_pairwise import (  # noqa: E402
    pallas_sweep_counts)
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from torch_thresholds import assert_port_counts, jax_under_port_thresholds  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
# max |component| of each db: int32 at L = 2 (P = 3), int16 at L = 3 (P = 6)
DBS = {"int32": 3000, "int16": 20000}
N, D = 150, 100
STAGE_KEYS = ("candidates", "emitted", "pairs_written")


def _write_db(path, dtype, n=N, d=D, seed=0):
    rng = np.random.default_rng(seed + DBS[dtype])
    m = DBS[dtype]
    V = rng.integers(-m, m + 1, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[10:30] = np.clip(V[9] + rng.integers(-2, 3, size=(20, d)), -m, m)
    V[100:110] = np.clip(V[3] + rng.integers(-2, 3, size=(10, d)), -m, m)
    V[0, 0] = m                                  # pins max_abs, hence L
    return DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d,
                          use_int16=dtype == "int16")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dbs, and shard folders made once a module: JAX two-phase runs
    (the JAX engine's output and counts do not depend on finalize), under
    its own thresholds and under the port's, and the port's fused
    shards."""
    root = tmp_path_factory.mktemp("two_phase")
    dbs = {t: _write_db(root / f"db_{t}", t) for t in DBS}
    made: dict = {}

    def jax_stages(dtype, stream, num_shards, tile, port_thr):
        key = ("jax", dtype, stream, num_shards, tile, port_thr)
        if key not in made:
            out = root / "_".join(map(str, key))
            stages = []
            with (jax_under_port_thresholds(dbs[dtype].path) if port_thr
                  else contextlib.nullcontext()):
                for s in range(num_shards):
                    jmc.compute_pairwise_shard(
                        dbs[dtype].path, str(out), num_shards, s,
                        tile_rows=tile, verbose=False, engine="two_phase",
                        device_budget_bytes=0 if stream else 8 << 30)
                    stages.append({k: jmc.LAST_STAGES[k]
                                   for k in STAGE_KEYS})
            made[key] = (out, stages)
        return made[key]

    def jax_run(dtype, stream, num_shards, tile):
        """-> (the JAX engine's shard folder, per shard its counters under
        its own thresholds and under the port's)."""
        want, stages = jax_stages(dtype, stream, num_shards, tile, False)
        return want, list(zip(stages, jax_stages(dtype, stream, num_shards,
                                                 tile, True)[1]))

    def fused_run(dtype, num_shards):
        key = ("fused", dtype, num_shards)
        if key not in made:
            out = root / "_".join(map(str, key))
            for s in range(num_shards):
                tmc.compute_pairwise_shard(dbs[dtype].path, str(out),
                                           num_shards, s, tile_rows=16,
                                           verbose=False, device="cpu")
                assert tmc.LAST_STAGES["mode"] == "fused"
            made[key] = out
        return made[key]

    return dbs, jax_run, fused_run


def _same_shards(a, b, num_shards):
    for s in range(num_shards):
        for f in SHARD_FILES:
            assert filecmp.cmp(a / f"shard_{s}" / f, b / f"shard_{s}" / f,
                               shallow=False), (str(a), str(b), s, f)


def _port(db, out, num_shards, tile, stream, **kw):
    """The port's two-phase shards of db -> each shard's LAST_STAGES."""
    stages = []
    for s in range(num_shards):
        tmc.compute_pairwise_shard(db.path, str(out), num_shards, s,
                                   tile_rows=tile, verbose=False,
                                   engine="two_phase", device="cpu",
                                   device_budget_bytes=0 if stream else None,
                                   **kw)
        stages.append(dict(tmc.LAST_STAGES))
    return stages


@pytest.mark.parametrize("tile", [8, 12, 16, 32])
@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
@pytest.mark.parametrize("finalize", ["host", "device"])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_two_phase_shards_equal_jax_and_fused(tmp_path, runs, dtype,
                                              finalize, stream, num_shards,
                                              tile):
    dbs, jax_run, fused_run = runs
    want, jax_stages = jax_run(dtype, stream, num_shards, tile)
    stages = _port(dbs[dtype], tmp_path / "port", num_shards, tile, stream,
                   finalize=finalize)
    _same_shards(tmp_path / "port", want, num_shards)
    _same_shards(tmp_path / "port", fused_run(dtype, num_shards), num_shards)
    for got, (j, jp) in zip(stages, jax_stages):
        assert got["mode"] == ("two_phase-streaming" if stream
                               else "two_phase")
        assert got["reruns"] == 0
        assert_port_counts(got, j, jp)


@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
def test_fused_engine_takes_two_phase_below_32_bit_tiles(tmp_path, runs,
                                                         stream):
    """engine="fused" at tile 12 (12^2 % 32 != 0) runs the two-phase
    engine, as in the JAX package, with JAX's counts and bytes."""
    dbs, jax_run, _ = runs
    want, jax_stages = jax_run("int32", stream, 1, 12)
    tmc.compute_pairwise_shard(dbs["int32"].path, str(tmp_path / "m"),
                               tile_rows=12, verbose=False, device="cpu",
                               device_budget_bytes=0 if stream else None)
    assert tmc.LAST_STAGES["mode"].startswith("two_phase")
    assert_port_counts(tmc.LAST_STAGES, *jax_stages[0])
    _same_shards(tmp_path / "m", want, 1)


@pytest.mark.parametrize("finalize", ["host", "device"])
@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
@pytest.mark.parametrize("slots", [2, 8])
def test_two_phase_mesh_equals_single_slot(tmp_path, runs, slots, stream,
                                           finalize):
    """Meshes of 2 and 8 CPU slots (one block of tiles each) write the
    single slot's bytes, with the same counts."""
    dbs, jax_run, _ = runs
    want, jax_stages = jax_run("int32", stream, 3, 16)
    stages = _port(dbs["int32"], tmp_path / "mesh", 3, 16, stream,
                   finalize=finalize,
                   mesh=Mesh([torch.device("cpu")] * slots))
    tmc.clear_device_cache()
    _same_shards(tmp_path / "mesh", want, 3)
    for got, j in zip(stages, jax_stages):
        assert_port_counts(got, *j)


@pytest.mark.parametrize("max_abs,d", [(3000, 100), (30000, 64),
                                       (1 << 23, 256)])
def test_exact_dots_device_equals_jax(max_abs, d):
    """ops.pairwise.exact_dots_device (kernel X's plain version on CPU
    tensors, one and two operands) equals the JAX package's on random
    pairs, up to L = 4 (d * max_abs^2 >= 2^53 at the last case)."""
    rng = np.random.default_rng(max_abs)
    n = 70
    V = rng.integers(-max_abs, max_abs + 1, size=(n, d)).astype(np.int32)
    V[0, :2] = [max_abs, -max_abs]
    L = pm.pick_limbs(max_abs)
    planes = torch.zeros((pm.num_planes(L), n, pw.pad_dim(d)),
                         dtype=torch.int8)
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V), L), 0)
    rows = rng.integers(0, n, size=500)
    cols = rng.integers(0, n, size=500)
    want = jpw.exact_dots_device(jpw.decompose_planes(jnp.asarray(V), L), L,
                                 rows, cols)
    got = pw.exact_dots_device(planes, L, rows, cols)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jpw.exact_dots_host(V, rows, cols, max_abs))
    # two operands: rows of planes[:, 20:], columns of planes[:, 5:60]
    two = pw.exact_dots_device(planes[:, 20:].contiguous(), L, rows % 50,
                               cols % 55, planes[:, 5:60].contiguous())
    np.testing.assert_array_equal(
        two, jpw.exact_dots_host(V, rows % 50 + 20, cols % 55 + 5, max_abs))


def _jax_engine_blocks(P, tile):
    """The JAX engine's rule, verbatim (matrix/compute.py:822-829)."""
    BI, BJ = (512, 512) if P <= 3 else (512, 128) if P <= 6 else (0, 0)
    while BI > 128 and tile % BI:
        BI //= 2
    while BJ > 128 and (tile % BJ or BJ > BI):
        BJ //= 2
    return BI, BJ


def test_engine_blocks_rule():
    cuda = torch.device("cuda")          # a device type: no card needed
    for P in (1, 3, 6, 10):
        for tile in (128, 256, 384, 512, 640, 1024, 2048, 4096):
            want = _jax_engine_blocks(P, tile)
            got = pp.engine_blocks(P, tile, cuda)
            assert got == (want if P <= 6 else (tile, tile)), (P, tile)
            assert tile % got[0] == 0 and tile % got[1] == 0
            assert pp.engine_blocks(P, tile, "cpu") == (tile, tile)


@pytest.mark.parametrize("max_abs,blocks", [(3000, (128, 128)),
                                            (20000, (256, 128)),
                                            (20000, (128, 128))])
def test_engine_counts_equal_pallas_kernel(max_abs, blocks):
    """The engine's per-tile counts (count_tiles, and its plain version
    swept at the JAX engine's sub-blocks, summed to the tile) equal the JAX
    Pallas kernel's, in interpret mode at those blocks, summed the same
    way; also through the mesh's per-slot tile lists."""
    rng = np.random.default_rng(7)
    n, d, tile = 512, 128, 256
    V = rng.integers(-max_abs, max_abs + 1, size=(n, d)).astype(np.int32)
    V[40:60] = np.clip(V[39] + rng.integers(-2, 3, size=(20, d)), -max_abs,
                       max_abs)
    V[300:310] = V[40]
    L = pm.pick_limbs(max_abs)
    ns = np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
    thr = (ns / d).astype(np.float32)
    planes = torch.zeros((pm.num_planes(L), n, pw.pad_dim(d)),
                         dtype=torch.int8)
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V), L), 0)
    t = torch.from_numpy(thr)
    bi, bj = blocks
    mi, mj = tile // bi, tile // bj
    nt = n // tile
    sub = np.asarray(pallas_sweep_counts(
        jpw.decompose_planes(jnp.asarray(V), L), jnp.asarray(thr),
        row_t0=0, row_t1=nt * mi, block=bi, block_j=bj, interpret=True))
    want = sub.reshape(nt, mi, nt, mj).sum(axis=(1, 3)).reshape(-1)
    coords = np.array([(r, c) for r in range(nt) for c in range(nt)])
    got = pp.count_tiles(planes, t, planes, t, coords, tile, d)
    assert got.dtype == torch.int32 and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pp.count_tiles_plain(
        planes, t, planes, t, coords, tile, d, blocks).numpy(), want)
    # the mesh's counts sweep (8 slots) returns the same, in coords order
    from metagenome_vector_sketches_tpu_torch.parallel.engine import (
        MeshSweepOps)
    ops = MeshSweepOps(Mesh([torch.device("cpu")] * 8))
    rep = ops.replicate(planes, t)
    np.testing.assert_array_equal(
        ops.sweep_counts(*rep, ops.tile_lists(coords), tile, d), want)


def test_fused_then_two_phase_stages_once(tmp_path, monkeypatch):
    """A fused shard, then a two-phase shard of one db: the second takes
    the residency slot's planes (stage_ms under 5% of the first's, nothing
    uploaded) and writes the fused shard's bytes."""
    rng = np.random.default_rng(3)
    n, d = 3000, 256
    V = rng.integers(-3000, 3001, size=(n, d)).astype(np.int32)
    V[100:110] = V[99]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    tmc.clear_device_cache()
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "fused"), 2, 1,
                               tile_rows=512, verbose=False, device="cpu")
    first = tmc.LAST_STAGES["stage_ms"]
    uploads = []
    real = tmc._upload_rows
    monkeypatch.setattr(tmc, "_upload_rows",
                        lambda *a: uploads.append(1) or real(*a))
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "two"), 2, 1,
                               tile_rows=512, verbose=False, device="cpu",
                               engine="two_phase")
    assert tmc.LAST_STAGES["mode"] == "two_phase"
    assert not uploads
    assert tmc.LAST_STAGES["stage_ms"] < 0.05 * first
    tmc.clear_device_cache()
    for f in SHARD_FILES:
        assert filecmp.cmp(tmp_path / "fused" / "shard_1" / f,
                           tmp_path / "two" / "shard_1" / f, shallow=False)


@pytest.mark.parametrize("case", ["low_counts", "budget"])
def test_advisory_counts(tmp_path, runs, monkeypatch, case):
    """The counts only size the extraction: counts below the truth make
    each slot rerun at its exact total (LAST_STAGES reruns); with a
    candidate budget below a chunk's true survivors as well, the chunk is
    halved down to one tile. Either way the JAX engine's bytes and
    counts."""
    from metagenome_vector_sketches_tpu_torch.parallel.engine import (
        MeshSweepOps)
    dbs, jax_run, _ = runs
    want, jax_stages = jax_run("int32", False, 1, 16)
    real_count = pp.count_tiles

    def low(*a):
        c = real_count(*a)
        return torch.where(c > 0, torch.clamp(c // 3, min=1), c)
    monkeypatch.setattr(pp, "count_tiles", low)
    refused = []
    real_extract = MeshSweepOps.sweep_extract_fused

    def extract(self, *a, **kw):
        res = real_extract(self, *a, **kw)
        refused.append(res is None)
        return res
    monkeypatch.setattr(MeshSweepOps, "sweep_extract_fused", extract)
    if case == "budget":
        monkeypatch.setattr(tmc, "CANDIDATE_BUDGET_BYTES", 40 * 20)
    tmc.compute_pairwise_shard(dbs["int32"].path, str(tmp_path / "m"),
                               tile_rows=16, verbose=False, device="cpu",
                               engine="two_phase",
                               mesh=Mesh([torch.device("cpu")] * 2))
    tmc.clear_device_cache()
    _same_shards(tmp_path / "m", want, 1)
    assert_port_counts(tmc.LAST_STAGES, *jax_stages[0])
    assert tmc.LAST_STAGES["reruns"] > 0
    assert any(refused) == (case == "budget")
