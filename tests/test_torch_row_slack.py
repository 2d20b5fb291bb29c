"""The sweep's per-row certified slack (matrix.compute._thresholds): the
stager's plane energies equal numpy's int64 sums of squares (chunks of one
row, a partial last chunk, the whole file; int32 and int16 files); a row's
slack never exceeds half of the db-wide required_slack_abs at the db's
largest component, for every plane bound a db can have; on adversarial
dbs (L = 1..4, rows at +-max_abs, small rows whose planes cancel, d a power
of two and not, pairs planted at exactly 0.05 (n_i + n_j) d, +1 and -1)
every pair the exact retention keeps, int32 or int16 semantics, passes the
plain float32 mask under the new thresholds, where thresholds without the
slack lose some; LAST_STAGES["slack_max"] on every staging path. Marked
``gpu``: kernel APPEND's survivors under the new thresholds equal the
plain path's bit for bit (skips where CUDA is not available). No JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel.engine import MeshSweepOps  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from torch_thresholds import plane_energies  # noqa: E402

# the largest component that L limbs hold: balanced digits of 63
MAX_ABS = {L: sum(63 << (7 * k) for k in range(L)) if L > 1 else 127
           for L in range(1, 5)}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _empty_slot():
    tmc.clear_device_cache()
    yield
    tmc.clear_device_cache()


def _planes(V, L):
    planes = torch.zeros((pm.num_planes(L), len(V), pw.pad_dim(V.shape[1])),
                         dtype=torch.int8)
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V), L), 0)
    return planes


@pytest.mark.parametrize("chunking", ["one_row", "partial", "whole"])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_stager_energies_equal_numpy(tmp_path, monkeypatch, dtype,
                                     chunking):
    n, d = 37, 100
    rng = np.random.default_rng(7)
    V = rng.integers(-20000, 20001, size=(n, d)).astype(np.int32)
    V[3] = 20000
    V[4] = rng.integers(-63, 64, size=d)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d, use_int16=dtype == "int16")
    row_bytes = d * (2 if dtype == "int16" else 4)
    monkeypatch.setattr(tmc, "STAGE_CHUNK_BYTES", {
        "one_row": 1, "partial": 8 * row_bytes, "whole": 1 << 30}[chunking])
    L = pm.pick_limbs(20000)
    for lo, hi in [(0, n), (5, 29), (9, 9)]:
        tmc._reset_stages()
        planes = torch.zeros((pm.num_planes(L), hi - lo, pw.pad_dim(d)),
                             dtype=torch.int8)
        with tmc._FileRows(db, n, d) as rows:
            got = tmc._upload_rows(planes, rows, lo, hi, L, 20000, db, CPU)
        assert got.dtype == np.int64 and got.shape == (6, hi - lo)
        np.testing.assert_array_equal(got, plane_energies(V[lo:hi], L))
        np.testing.assert_array_equal(
            got, pw.plane_energies(planes).numpy())


def _plane_bound_cases():
    """(L, max_abs) covering every plane bound vector a db can give
    (pairwise_math.plane_value_bounds): L = 1 at each max_abs, L >= 2 at
    each top limb, with the low limbs at their largest and at zero."""
    cases = [(1, m) for m in range(1, 128)]
    for L in range(2, 6):
        base = 128 ** (L - 1)
        low = sum(63 << (7 * k) for k in range(L - 1))
        for top in range(0, 64):
            for m in (top * base, top * base + low, top * base - 64):
                if 0 < m < 1 << 31:
                    cases.append((L, m))
    return cases


def test_row_slack_never_exceeds_half_the_db_wide_bound():
    """For every plane bound m_p a db can have, SLACK_INFLATE sum_p kappa_p
    m_p^2 <= required_slack_abs per unit d: with E_p(i) <= d m_p^2 every
    row's 2 SLACK_INFLATE sigma_i stays within the JAX engine's slack."""
    for L, m in _plane_bound_cases():
        b = np.asarray(pm.plane_value_bounds(L, m), dtype=np.float64)
        bound = tmc.SLACK_INFLATE * float(tmc._plane_error_weights(L) @ b**2)
        assert bound <= pm.required_slack_abs(L, m, 1), (L, m)


def _adversarial(L, d, seed=0):
    """Rows at +-max_abs, small rows (every limb above the first 0, so the
    Karatsuba terms cancel), random rows and planted pairs: (a, a + noise)
    whose two rows' squared norms put the pair at exactly 0.05 (n_a + n_b)
    d = dot + k, k = -1, 0, 1 in turn. -> (V, norms_sq, max_abs)."""
    rng = np.random.default_rng(seed + 100 * L + d)
    m = MAX_ABS[L]
    rows = [rng.choice([-m, m], size=(8, d)),
            rng.integers(-63, 64, size=(16, d)),
            rng.integers(-m, m + 1, size=(8, d))]
    V = np.concatenate(rows).astype(np.int64)
    V[1] = V[0]
    V[2] = -V[0]
    V[9] = V[8]
    ns = np.einsum("nd,nd->n", V, V) / d * rng.uniform(0.5, 2.0, len(V))
    planted, pns = [], []
    for t in range(90):
        src = rows[t % 3][rng.integers(len(rows[t % 3]))]
        a = src.astype(np.int64)
        b = np.clip(a + rng.integers(-2, 3, size=d), -m, m)
        dot = int(a @ b)
        n = (dot + (t % 3) - 1) / (0.1 * d)        # 0.05 (n + n) d = dot + k
        planted += [a, b]
        pns += [n, n]
    V = np.concatenate([V, np.stack(planted)]).astype(np.int32)
    V[0, 0] = m
    return V, np.concatenate([ns, pns]), m


@pytest.mark.parametrize("d", [128, 200])
@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_every_kept_pair_passes_the_mask(L, d):
    V, ns, max_abs = _adversarial(L, d)
    assert pm.pick_limbs(max_abs) == L
    planes = _planes(V, L)
    thr, slack = tmc._thresholds(ns, plane_energies(V, L), L, d)
    assert 2 * tmc.SLACK_INFLATE * slack <= pm.required_slack_abs(L, max_abs,
                                                                  d)
    approx = pw.approx_dot_f32(planes, planes)
    dots = V.astype(np.int64) @ V.astype(np.int64).T
    exact = 0.05 * (ns[:, None] + ns[None, :])
    kept = {"int32": pm.exact_filter_int32(dots, exact, d),
            "int16": pm.exact_filter_int16(dots, exact, d)}
    t = torch.from_numpy(thr)
    mask = pw.retention_mask(approx, t, t, d).numpy()
    for sem, keep in kept.items():
        assert keep.any() and not (keep & ~mask).any(), sem
    # the planted pairs sit on the boundary on both sides
    a = np.arange(len(ns) - 180, len(ns), 2)
    assert kept["int16"][a, a + 1].any() and not kept["int16"][a, a + 1].all()
    if L >= 3:
        # the float32 combine's error is real here: thresholds without the
        # rows' slack drop pairs the exact retention keeps
        bare = torch.from_numpy((ns + 10.0 * float(pm.SLACK_ABS))
                                .astype(np.float32))
        lost = kept["int16"] & ~pw.retention_mask(approx, bare, bare,
                                                  d).numpy()
        assert lost.any()


def _engine_db(path, n=96, d=64):
    """Tiny sets' rows (small components) beside a few large rows: L = 2."""
    rng = np.random.default_rng(5)
    sizes = rng.integers(3, 400, size=n)
    V = (2 * rng.binomial(sizes[:, None], 0.5, size=(n, d))
         - sizes[:, None]).astype(np.int32)
    V[5] = 3000
    V[40:50] = np.clip(V[39] + rng.integers(-1, 2, size=(10, d)), -3000,
                       3000)
    names = [f"S{i}" for i in range(n)]
    return DbFolder.write(str(path), names, V, d), V


@pytest.mark.parametrize("stream", [False, True],
                         ids=["resident", "streaming"])
@pytest.mark.parametrize("engine", ["fused", "two_phase"])
def test_slack_max_on_every_staging_path(tmp_path, engine, stream):
    """slack_max is the db's largest sigma_i (its rows are all staged) on
    the resident and streaming engines, fused and two-phase, on a 2-slot
    mesh and on a residency hit; the resident slot holds the thresholds
    built from numpy's energies."""
    db, V = _engine_db(tmp_path / "db")
    n, d = V.shape
    _, norms = db.names_and_norms()
    L = pm.pick_limbs(3000)
    thr, want = tmc._thresholds(norms * norms, plane_energies(V, L), L, d)
    assert 0 < want
    for shard, mesh in ((0, None), (1, Mesh([CPU] * 2))):
        tmc.compute_pairwise_shard(
            db.path, str(tmp_path / "m"), num_shards=2, shard_idx=shard,
            tile_rows=16, verbose=False, device="cpu", engine=engine,
            mesh=mesh, device_budget_bytes=0 if stream else None)
        assert tmc.LAST_STAGES["slack_max"] == pytest.approx(want, rel=1e-12)
        if not stream:
            np.testing.assert_array_equal(
                tmc._RESIDENT["value"][1][:n].numpy(), thr)
    if not stream:
        tmc.compute_pairwise_shard(
            db.path, str(tmp_path / "m"), num_shards=2, shard_idx=0,
            tile_rows=16, verbose=False, device="cpu", engine=engine,
            mesh=Mesh([CPU] * 2))
        assert tmc.LAST_STAGES["stage_bytes"] == 0          # a hit
        assert tmc.LAST_STAGES["slack_max"] == pytest.approx(want,
                                                             rel=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2048, 200])
def test_append_survivors_equal_plain_under_row_thresholds(tmp_path, d):
    """Kernel APPEND (and its COUNT twin's counts) on planes and thresholds
    staged on the card equal the plain path's on the CPU staging of the
    same db, bit for bit: thresholds, survivors and per-tile counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    db, V = _engine_db(tmp_path / "db", n=1024, d=d)
    n = len(V)
    _, norms = db.names_and_norms()
    L = pm.pick_limbs(3000)
    tile = 256
    coords = np.array([(r, c) for r in range(4) for c in range(4)],
                      dtype=np.int32)
    got = {}
    for dev in (CPU, torch.device("cuda")):
        tmc.clear_device_cache()
        tmc._reset_stages()
        ops = MeshSweepOps(Mesh([dev]))
        planes, thr = tmc._stage_database(db, norms * norms, n, tile, L, d,
                                          3000, ops, ("row_slack", dev.type))
        planes, thr = planes[0], thr[0]
        rc, counts, total = pw.sweep_extract(planes, thr, planes, thr,
                                             pw.TileList(coords, dev), tile,
                                             n * n, True, d)
        k = int(total.cpu()[0])
        got[dev.type] = (thr.cpu(), counts.cpu(),
                         sorted(map(tuple, rc[:k].cpu().tolist())),
                         pp.count_tiles(planes, thr, planes, thr,
                                        pw.TileList(coords, dev), tile,
                                        d).cpu(),
                         tmc.LAST_STAGES["slack_max"])
    tmc.clear_device_cache()
    a, b = got["cpu"], got["cuda"]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2] == b[2] and len(a[2]) > 0
    assert torch.equal(a[3], b[3]) and a[4] == b[4]
