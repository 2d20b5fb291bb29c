"""The port's multi-device layer against the JAX package's on the CPU: the
JAX side runs on the conftest's 8 virtual XLA devices (``make_mesh(8)``),
the port on an 8-slot mesh of the one CPU device, on the same seeded numpy
inputs. Shard folders are byte-equal, the sharded sweep counts and the
pipeline step's survivors equal, the distributed int8 index's (D, I)
equal, and the f32 top-k returns the same index sets (or sorted scores
within rtol 1e-6 where ties swap)."""

import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as JP  # noqa: E402

from helpers import assert_matrix_matches_oracle  # noqa: E402
from metagenome_vector_sketches_tpu.ann import distributed as jdist  # noqa: E402
from metagenome_vector_sketches_tpu.ann import int_index as jii  # noqa: E402
from metagenome_vector_sketches_tpu.ann import search as jsearch  # noqa: E402
from metagenome_vector_sketches_tpu.ann.flat_index import normalize_l2  # noqa: E402
from metagenome_vector_sketches_tpu.cli import pairwise_comp as j_pairwise  # noqa: E402
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.io.hashes import parse_hashes_file  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu.ops import pairwise as jpw  # noqa: E402
from metagenome_vector_sketches_tpu.ops.projection import project_device_batch  # noqa: E402
from metagenome_vector_sketches_tpu.ops.splitmix import split_u64  # noqa: E402
from metagenome_vector_sketches_tpu.parallel import mesh as jmesh  # noqa: E402
from metagenome_vector_sketches_tpu.parallel import multihost as jmh  # noqa: E402
from metagenome_vector_sketches_tpu.parallel import pairwise as jpar  # noqa: E402
from metagenome_vector_sketches_tpu.parallel.pipeline import make_pipeline_step as j_step  # noqa: E402
from metagenome_vector_sketches_tpu_torch import _device  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import distributed as tdist  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import flat_index as tfi  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import int_index as tii  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import search as tsearch  # noqa: E402
from metagenome_vector_sketches_tpu_torch.cli import pairwise_comp as t_pairwise  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import projection as tpj  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel import engine as tengine  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel import multihost as tmh  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel import pairwise as tpar  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return tmesh.Mesh([CPU] * 8)


@pytest.fixture
def eight_cpu_devices(monkeypatch):
    """The port's --mesh_devices resolution on a host that has 8 devices of
    the CPU's type (torch has one CPU device; a mesh repeats it)."""
    monkeypatch.setattr(_device, "local_device_count", lambda dev: 8)
    monkeypatch.setattr(tmesh, "local_devices", lambda device: [CPU] * 8)


def _same_topk(scores, got, want):
    """Per row: the same index set, or the sorted scores within rtol 1e-6
    where ties swap (test_parallel.py's check)."""
    for b in range(scores.shape[0]):
        g, w = set(got[b].tolist()), set(want[b].tolist())
        if g != w:
            np.testing.assert_allclose(np.sort(scores[b][list(g)]),
                                       np.sort(scores[b][list(w)]),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# the mesh: construction and --mesh_devices resolution
# ---------------------------------------------------------------------------

def test_serving_mesh_semantics(monkeypatch):
    """1 -> None, 0 -> every local device, n -> the first n; n < 0 and n
    above the local count raise (JAX test_multihost.py's checks, on one
    CPU device and then on 8)."""
    assert tmesh.serving_mesh(1, device="cpu") is None
    assert tmesh.serving_mesh(0, device="cpu") is None     # one CPU device
    for bad in (-1, 2, 4096):
        with pytest.raises(ValueError, match="mesh_devices"):
            tmesh.serving_mesh(bad, device="cpu")
        with pytest.raises(ValueError):
            jmesh.serving_mesh(bad if bad != 2 else 4096)
    monkeypatch.setattr(_device, "local_device_count", lambda dev: 8)
    monkeypatch.setattr(tmesh, "local_devices", lambda device: [CPU] * 8)
    assert tmesh.serving_mesh(0, device="cpu").size == \
        jmesh.serving_mesh(0).devices.size == 8
    assert tmesh.serving_mesh(2, device="cpu").size == \
        jmesh.serving_mesh(2).devices.size == 2
    with pytest.raises(ValueError, match="need 9 local devices, have 8"):
        tmesh.serving_mesh(9, device="cpu")
    # the search entry point's resolution (JAX test_ann.py)
    with pytest.raises(ValueError, match="mesh_devices"):
        jsearch._serving_mesh(-4)
    with pytest.raises(ValueError, match="mesh_devices"):
        tsearch.search_index("unused", "unused", 0.1, mesh_devices=-4,
                             device="cpu")


def test_mesh_slots_split_and_replicate(tmesh8):
    x = torch.arange(48).reshape(16, 3)
    blocks = tmesh.row_sharding(tmesh8, x)
    assert [b.shape[0] for b in blocks] == [2] * 8
    assert torch.equal(torch.cat(blocks), x)
    assert all(r is x for r in tmesh.replicated(tmesh8, x))   # no copies
    assert torch.equal(tmesh8.gather_slots(blocks), x)
    assert tmesh8.all_gather(x) is x                         # one process
    with pytest.raises(ValueError, match="split"):
        tmesh.row_sharding(tmesh8, torch.zeros(12, 2))
    with pytest.raises(ValueError, match="at least one"):
        tmesh.Mesh([])
    ops = tengine.MeshSweepOps(tmesh8)
    blocks, t = ops._pad(np.arange(22).reshape(11, 2))
    assert t == 11 and [len(b) for b in blocks] == [2] * 5 + [1] + [0] * 2
    counts = np.arange(11)
    assert ops.block_total_max(counts) == max(
        counts[s * 2:(s + 1) * 2].sum() for s in range(8))
    lists = ops.tile_lists(np.arange(22).reshape(11, 2))
    assert [0 if t is None else len(t) for t in lists] == [2] * 5 + [1, 0, 0]


# ---------------------------------------------------------------------------
# parallel.pairwise: sharded counts, distributed top-k; the pipeline step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clustered", [False, True])
def test_sharded_pairwise_counts_equal_jax(jmesh8, tmesh8, clustered):
    """test_parallel.py's random rows with thresholds |v|^2 (no pair
    passes), and clustered rows with the engine's |v|^2 / d (self-pairs
    and near-duplicates pass)."""
    rng = np.random.default_rng(31)
    N, d = 64, 128
    V = rng.integers(-300, 300, size=(N, d)).astype(np.int32)
    norms_sq = np.einsum("ij,ij->i", V.astype(np.float64),
                         V.astype(np.float64))
    if clustered:
        V = _clustered(n=N, d=d, seed=31)
        norms_sq = np.einsum("ij,ij->i", V.astype(np.float64),
                             V.astype(np.float64)) / d
    norms_sq = norms_sq.astype(np.float32)
    L = jpw.pick_limbs(300)
    limbs = np.asarray(jpw.decompose_limbs(jnp.asarray(V), L))
    want = np.asarray(jpar.sharded_pairwise_counts(
        jmesh8,
        jax.device_put(jnp.asarray(limbs),
                       NamedSharding(jmesh8, JP(None, "data", None))),
        jax.device_put(jnp.asarray(norms_sq), jmesh.row_sharding(jmesh8)),
        d))
    got = tpar.sharded_pairwise_counts(tmesh8, limbs, norms_sq, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dots = V.astype(np.int64) @ V.astype(np.int64).T
    exact = (dots / d > 0.05 * (norms_sq[:, None].astype(np.float64)
                                + norms_sq[None, :])).sum(axis=1)
    assert (got.numpy() >= exact).all()
    assert (got.numpy() > 0).any() == clustered


@pytest.mark.parametrize("N,B,k,n_valid", [(256, 5, 7, None),
                                           (88, 3, 20, 83)])
def test_distributed_topk_equals_jax(jmesh8, tmesh8, N, B, k, n_valid):
    rng = np.random.default_rng(32 + N)
    d = 64
    V = normalize_l2(rng.normal(size=(N, d)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(B, d)).astype(np.float32))
    if n_valid is not None:
        V[n_valid:] = 0.0                          # pad rows score -inf
    Dj, Ij = jpar.distributed_topk(
        jmesh8, jax.device_put(jnp.asarray(Q), jmesh.replicated(jmesh8)),
        jax.device_put(jnp.asarray(V), jmesh.row_sharding(jmesh8)), k,
        n_valid=n_valid)
    Dt, It = tpar.distributed_topk(tmesh8, Q, V, k, n_valid=n_valid)
    assert Dt.shape == (B, k) and It.dtype == torch.int64
    scores = Q.astype(np.float64) @ V.astype(np.float64).T
    _same_topk(scores, It.numpy(), np.asarray(Ij))
    np.testing.assert_allclose(np.sort(Dt.numpy(), axis=1),
                               np.sort(np.asarray(Dj), axis=1), rtol=1e-6)
    if n_valid is not None:
        assert It.max() < n_valid


def test_distributed_topk_row_ids_mask_pads(tmesh8):
    """Explicit per-row ids (-1 = pad) in the middle of the layout: pads
    never appear, and the ids are what comes back."""
    rng = np.random.default_rng(34)
    V = normalize_l2(rng.normal(size=(32, 16)).astype(np.float32))
    Q = -V[:2]                                   # anti-correlated queries
    ids = np.arange(32) + 100
    ids[3:7] = -1
    D, I = tpar.distributed_topk(tmesh8, Q, V, 30, row_ids=ids)
    I = I.numpy()
    assert np.isin(I[I >= 0], ids[ids >= 0]).all()
    assert (I == -1).sum() == 2 * 2 and torch.isinf(D[I < 0]).all()


def _sets(rng, B, H):
    sets = rng.integers(0, 1 << 64, size=(B, H), dtype=np.uint64)
    counts = rng.integers(1, H + 1, size=B).astype(np.int32)
    for b in range(B):
        sets[b, counts[b]:] = 0
    return sets, counts


def test_distributed_projection_batch_equals_jax(jmesh8, tmesh8):
    """The pipeline's data-parallel projection: each slot projects its rows
    (kernel P's plain version on the CPU), equal to JAX's row-sharded
    project_device_batch."""
    rng = np.random.default_rng(33)
    B, H, d = 16, 128, 128
    sets, counts = _sets(rng, B, H)
    hi, lo = split_u64(sets)
    sh = jmesh.row_sharding(jmesh8)
    want = np.asarray(project_device_batch(
        jax.device_put(jnp.asarray(hi), sh),
        jax.device_put(jnp.asarray(lo), sh),
        jax.device_put(jnp.asarray(counts), sh), d))
    b = B // tmesh8.size
    got = []
    for s, dev in enumerate(tmesh8.devices):
        rows = slice(s * b, (s + 1) * b)
        flat, offsets = tpipe._csr(hi[rows], lo[rows], counts[rows])
        with tmesh8.slot(s):
            got.append(tpj.project_batch(flat, offsets, d, dev))
    np.testing.assert_array_equal(tmesh8.gather_slots(got).numpy(), want)


@pytest.mark.parametrize("B,d,L,k", [(16, 128, 1, 5), (24, 96, 2, 40)])
def test_pipeline_step_equals_jax(jmesh8, tmesh8, B, d, L, k):
    """make_pipeline_step: survivors equal JAX's exactly (raw threshold),
    the top-k of each sketch the same set (or near-ties)."""
    rng = np.random.default_rng(35 + B)
    sets, counts = _sets(rng, B, 96)
    sets[1] = sets[0]                            # a duplicate set
    counts[1] = counts[0]
    hi, lo = split_u64(sets)
    sh = jmesh.row_sharding(jmesh8)
    js, ji, jd = j_step(jmesh8, d, L, k)(
        *(jax.device_put(jnp.asarray(x), sh) for x in (hi, lo, counts)))
    ts, ti, td = tpipe.make_pipeline_step(tmesh8, d, L, k)(hi, lo, counts)
    assert ts.dtype == torch.int32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ti.shape == np.asarray(ji).shape == (B, min(k, B))
    vecs = np.stack([tpj.project_many([sets[b, :counts[b]]], d, "cpu")[0]
                     for b in range(B)]).astype(np.float64)
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    _same_topk(unit @ unit.T, ti.numpy(), np.asarray(ji))
    # float32 products of unit vectors: equal to a few roundings
    np.testing.assert_allclose(np.sort(td.numpy(), axis=1),
                               np.sort(np.asarray(jd), axis=1), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(ValueError, match="split"):
        tpipe.make_pipeline_step(tmesh8, d, L, k)(hi[:3], lo[:3], counts[:3])


# ---------------------------------------------------------------------------
# the mesh-sharded pairwise engine: shard folders byte-equal to JAX's
# ---------------------------------------------------------------------------

def _clustered(n=96, d=128, n_clusters=3, cluster_size=9, seed=41,
               max_mag=300):
    """test_parallel.py's db: dense clusters of near-identical rows plus
    background rows."""
    rng = np.random.default_rng(seed)
    V = rng.integers(-max_mag, max_mag + 1, size=(n, d)).astype(np.int32)
    pos = 0
    for _ in range(n_clusters):
        proto = rng.integers(-max_mag, max_mag + 1, size=d).astype(np.int32)
        for _ in range(cluster_size):
            V[pos] = proto + rng.integers(-2, 3, size=d).astype(np.int32)
            pos += 1
    return V


def _fused_db(seed, n=128, d=64):
    """test_fused_engine.py's mesh dbs."""
    rng = np.random.default_rng(seed)
    V = rng.integers(-300, 301, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[40:56] = V[39] + rng.integers(-1, 2, size=(16, d)).astype(np.int32)
    return V


def _orthogonal_clusters(n=128, d=64, seed=52):
    """test_round5_fixes.py's db for the gated engine: cold cross tiles."""
    rng = np.random.default_rng(seed)
    V = np.zeros((n, d), dtype=np.int32)
    V[:n // 2, :d // 2] = rng.integers(40, 61, size=(n // 2, d // 2))
    V[n // 2:, d // 2:] = rng.integers(40, 61, size=(n - n // 2, d - d // 2))
    return V


def _device_finalize_db():
    rng = np.random.default_rng(33)
    V = rng.integers(-300, 301, size=(64, 128)).astype(np.int32)
    V[1] = V[0]
    return V


# case -> (vectors, int16, num_shards, engine keyword arguments); the JAX
# tests they mirror: test_parallel.py (full shard int32/int16, sharded
# rows, streaming), test_fused_engine.py (fused, fused-streaming),
# test_round2_fixes.py (device finalize), test_round5_fixes.py (gate)
SHARD_CASES = {
    "full-int32": (lambda: _clustered(), False, 1, {}),
    "full-int16": (lambda: _clustered(), True, 1, {}),
    "rows-3-shards": (lambda: _clustered(n=40, seed=43), False, 3, {}),
    "streaming": (lambda: _clustered(n=64, seed=44), False, 1,
                  {"device_budget_bytes": 3 * 16 * 128 * 2}),
    "fused": (lambda: _fused_db(93), False, 1, {}),
    "fused-streaming": (lambda: _fused_db(97), False, 1,
                        {"device_budget_bytes": 0}),
    "device-finalize": (_device_finalize_db, False, 1,
                        {"finalize": "device"}),
    "gate": (_orthogonal_clusters, False, 1, {"gate": True}),
}


def _assert_same_bytes(a, b, shards):
    for s in shards:
        for f in SHARD_FILES:
            assert filecmp.cmp(a / f"shard_{s}" / f, b / f"shard_{s}" / f,
                               shallow=False), f"shard {s} {f}"


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_mesh_shard_byte_equal_to_jax(tmp_path, jmesh8, tmesh8, case):
    make, int16, num_shards, kw = SHARD_CASES[case]
    V = make()
    n, d = V.shape
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i:04d}" for i in range(n)],
                        V, d, use_int16=int16)
    for s in range(num_shards):
        jmc.compute_pairwise_shard(db.path, str(tmp_path / "jax"),
                                   num_shards=num_shards, shard_idx=s,
                                   tile_rows=16, verbose=False, mesh=jmesh8,
                                   **kw)
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "port"),
                                   num_shards=num_shards, shard_idx=s,
                                   tile_rows=16, verbose=False, mesh=tmesh8,
                                   device="cpu", **kw)
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "single"),
                                   num_shards=num_shards, shard_idx=s,
                                   tile_rows=16, verbose=False, device="cpu",
                                   **kw)
    want_mode = "fused-streaming" if "device_budget_bytes" in kw \
        else "fused"
    assert tmc.LAST_STAGES["mode"] == jmc.LAST_STAGES["mode"] == want_mode
    _assert_same_bytes(tmp_path / "jax", tmp_path / "port", range(num_shards))
    _assert_same_bytes(tmp_path / "single", tmp_path / "port",
                       range(num_shards))
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(db.load_vectors().astype(np.int32),
                                 norms * norms, d, str(tmp_path / "port"), n,
                                 db.dtype)


def test_mesh_round_reruns_and_halves(tmp_path, tmesh8, monkeypatch):
    """Per-slot exact-capacity reruns (a slot's survivors past the cap)
    and the halving of a round whose slot buffer breaks the budget keep
    the shard byte-equal to the single-device one."""
    V = _fused_db(98, n=96)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(96)],
                        V, 64)
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "single"),
                               tile_rows=16, verbose=False, device="cpu")
    monkeypatch.setattr(tmc, "SWEEP_CAP_START", 1)
    monkeypatch.setattr(tmc, "CANDIDATE_BUDGET_BYTES", 4 * 16 * 16)
    calls = []
    real = tengine.MeshSweepOps.sweep_extract_fused

    def spy(self, *a, **kw):
        res = real(self, *a, **kw)
        calls.append(res is None)
        return res

    monkeypatch.setattr(tengine.MeshSweepOps, "sweep_extract_fused", spy)
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "port"),
                               tile_rows=16, verbose=False, mesh=tmesh8,
                               device="cpu")
    assert any(calls) and not all(calls)         # halved, then ran
    _assert_same_bytes(tmp_path / "single", tmp_path / "port", [0])


def test_multihost_local_mesh_engine(tmp_path, jmesh8, tmesh8):
    """compute_pairwise_multihost: one process, every shard mesh-parallel
    (the JAX package's local mesh is its 8 virtual devices; the port's is
    given as mesh=), byte-equal to JAX's."""
    V = _clustered(n=48, seed=45)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i:04d}" for i in range(48)],
                        V, 128)
    jf = jmh.compute_pairwise_multihost(db.path, str(tmp_path / "jax"),
                                        num_shards=2, tile_rows=16,
                                        verbose=False)
    tf = tmh.compute_pairwise_multihost(db.path, str(tmp_path / "port"),
                                        num_shards=2, tile_rows=16,
                                        verbose=False, mesh=tmesh8,
                                        device="cpu")
    assert [f.replace("port", "jax") for f in tf] == jf
    _assert_same_bytes(tmp_path / "jax", tmp_path / "port", [0, 1])
    # the default: this process's local mesh (one CPU device)
    tmh.compute_pairwise_multihost(db.path, str(tmp_path / "local"),
                                   num_shards=2, tile_rows=16, verbose=False,
                                   device="cpu")
    _assert_same_bytes(tmp_path / "jax", tmp_path / "local", [0, 1])


def test_pairwise_comp_cli_mesh_devices(tmp_path, ref_toy_dir,
                                        eight_cpu_devices):
    """--mesh_devices 8 where 8 local devices exist: the port's shard is the
    JAX CLI's, byte for byte."""
    db = str(ref_toy_dir / "toy_db_256")
    args = ["--db", db, "--max_memory_gb", "1", "--num_threads", "1",
            "--num_shards", "2", "--shard_idx", "1", "--tile", "16",
            "--mesh_devices", "8"]
    assert j_pairwise.main(args + ["--output_folder",
                                   str(tmp_path / "jax")]) == 0
    assert t_pairwise.main(args + ["--output_folder", str(tmp_path / "port"),
                                   "--device", "cpu"]) == 0
    _assert_same_bytes(tmp_path / "jax", tmp_path / "port", [1])


# ---------------------------------------------------------------------------
# distributed ANN indexes
# ---------------------------------------------------------------------------

def _int_case_from_index(seed, n, d, R, m, B, k, mode="exact"):
    rng = np.random.default_rng(seed)
    V = rng.integers(-m, m + 1, size=(n, d)).astype(np.int32)
    Q = rng.integers(-m, m + 1, size=(B, d)).astype(np.int32)
    kw = {"mode": mode, "recall_target": 0.9} if mode != "exact" else {}

    def build(side, mesh):
        if side == "jax":
            return jdist.DistributedIntExactIndex.from_index(
                jii.IntExactIndex(V, chunk_rows=R, **kw), mesh=mesh)
        return tdist.DistributedIntExactIndex.from_index(
            tii.IntExactIndex(V, chunk_rows=R, device="cpu", **kw),
            mesh=mesh)
    return V, Q, k, build


def _int_case_process_shards(seed, n, d, R, m, B, k):
    rng = np.random.default_rng(seed)
    V = rng.integers(-m, m + 1, size=(n, d)).astype(np.int32)
    Q = rng.integers(-m, m + 1, size=(B, d)).astype(np.int32)

    def build(side, mesh):
        mod = jdist if side == "jax" else tdist
        kw = {} if side == "jax" else {"device": "cpu"}
        return mod.DistributedIntExactIndex.from_process_shards(
            V, d, mesh=mesh, chunk_rows=R, **kw)
    return V, Q, k, build


# the JAX tests of test_int_index.py they mirror: matches single (C=10 on
# 8 slots), small shards fill the pool (k above a slot's rows), from
# process shards, approx mode
INT_CASES = {
    "from-index": lambda: _int_case_from_index(17, 150, 64, 16, 700, 5, 12),
    "small-shards-fill-pool": lambda: _int_case_from_index(19, 64, 32, 8,
                                                           200, 2, 20),
    "process-shards": lambda: _int_case_process_shards(23, 109, 48, 16, 600,
                                                       4, 13),
    "approx": lambda: _int_case_from_index(29, 140, 64, 16, 400, 3, 10,
                                           mode="approx"),
}


@pytest.mark.parametrize("case", sorted(INT_CASES))
def test_distributed_int_index_equals_jax(jmesh8, tmesh8, case):
    V, Q, k, build = INT_CASES[case]()
    Dj, Ij = build("jax", jmesh8).search(Q, k)
    tidx = build("port", tmesh8)
    Dt, It = tidx.search(Q, k)
    assert np.array_equal(It, Ij) and np.array_equal(Dt, Dj)
    Ds, Is = tii.IntExactIndex(V, chunk_rows=tidx.chunk_rows,
                               device="cpu").search(Q, k)
    assert np.array_equal(It, Is) and np.array_equal(Dt, Ds)
    assert (It >= 0).all() and It.dtype == np.int32


def test_distributed_int_index_from_dbfolder_equals_jax(tmp_path, jmesh8,
                                                        tmesh8):
    """Straight-to-slot staging (C=9 chunks over 8 slots, an odd tail)."""
    rng = np.random.default_rng(23)
    n, d, R = 141, 64, 16
    V = rng.integers(-900, 901, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i:04d}" for i in range(n)],
                        V, d)
    Q = rng.integers(-900, 901, size=(6, d)).astype(np.int32)
    j = jdist.DistributedIntExactIndex.from_dbfolder(db.path, chunk_rows=R,
                                                     mesh=jmesh8)
    t = tdist.DistributedIntExactIndex.from_dbfolder(db.path, chunk_rows=R,
                                                     mesh=tmesh8)
    assert (t.L, t.max_abs) == (j.L, j.max_abs)
    np.testing.assert_array_equal(t.ns, j.ns)
    Dj, Ij = j.search(Q, 10)
    Dt, It = t.search(Q, 10)
    assert np.array_equal(It, Ij) and np.array_equal(Dt, Dj)
    single = tii.IntExactIndex.from_dbfolder(db.path, chunk_rows=R,
                                             device="cpu")
    Ds, Is = single.search(Q, 10)
    assert np.array_equal(It, Is) and np.array_equal(Dt, Ds)
    with pytest.raises(TypeError, match="from_index"):
        tdist.DistributedIntExactIndex()


# the f32 flat index: test_multihost.py (matches flat, from process shards)
# and test_round2_fixes.py (pad rows keep negative neighbours)
def _flat_matches_flat(jmesh8, tmesh8):
    rng = np.random.default_rng(51)
    V = normalize_l2(rng.normal(size=(203, 64)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(4, 64)).astype(np.float32))
    return V, Q, 7, jdist.DistributedFlatIPIndex(V, mesh=jmesh8), \
        tdist.DistributedFlatIPIndex(V, mesh=tmesh8)


def _flat_process_shards(jmesh8, tmesh8):
    rng = np.random.default_rng(57)
    V = normalize_l2(rng.normal(size=(117, 48)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(3, 48)).astype(np.float32))
    return V, Q, 9, \
        jdist.DistributedFlatIPIndex.from_process_shards(V, 48, mesh=jmesh8), \
        tdist.DistributedFlatIPIndex.from_process_shards(V, 48, mesh=tmesh8)


def _flat_negative_neighbours(jmesh8, tmesh8):
    rng = np.random.default_rng(61)
    V = normalize_l2(rng.normal(size=(11, 16)).astype(np.float32))
    Q = normalize_l2(-V[:2] + 0.01 * rng.normal(size=(2, 16))
                     .astype(np.float32))
    return V, Q, 8, jdist.DistributedFlatIPIndex(V, mesh=jmesh8), \
        tdist.DistributedFlatIPIndex.from_flat(
            tfi.FlatIPIndex(V, device="cpu"), mesh=tmesh8)


FLAT_CASES = {"matches-flat": _flat_matches_flat,
              "process-shards": _flat_process_shards,
              "negative-neighbours": _flat_negative_neighbours}


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_distributed_flat_index_equals_jax(jmesh8, tmesh8, case):
    V, Q, k, j, t = FLAT_CASES[case](jmesh8, tmesh8)
    assert t.ntotal == j.ntotal == len(V)
    Dj, Ij = j.search(Q, k)
    Dt, It = t.search(Q, k)
    assert It.dtype == np.int32 and (It >= 0).all() and (It < len(V)).all()
    scores = Q.astype(np.float64) @ V.astype(np.float64).T
    _same_topk(scores, It, Ij)
    np.testing.assert_allclose(np.sort(Dt, axis=1), np.sort(Dj, axis=1),
                               rtol=1e-5, atol=1e-6)
    Dd, Id = t.search_device(torch.from_numpy(Q), k)
    np.testing.assert_array_equal(Id.numpy(), It)


def test_search_index_mesh_equals_jax(ref_toy_dir, tmp_path,
                                      eight_cpu_devices):
    """search_index with mesh_devices=8 serves through the distributed
    indexes (both engines) and returns the JAX mesh search's hits and the
    port's single-device hits (JAX test_ann.py)."""
    import shutil
    from metagenome_vector_sketches_tpu.ann.flat_index import index_vectors
    db = tmp_path / "db"
    shutil.copytree(str(ref_toy_dir / "toy_db_2048"), db)
    index_vectors(str(db), verbose=False)
    hashes = dict(parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt")))
    names, _ = DbFolder(str(db)).names_and_norms()
    qf = tmp_path / "q.txt"
    with open(qf, "w") as f:
        for n in names[:4]:
            f.write(f"{n}: " + " ".join(str(h) for h in hashes[n]) + "\n")
    # f32: XLA and torch sum the products in other orders (1e-5, as
    # test_torch_ann.py's single-device comparison allows)
    for engine, tol in (("f32", 1e-5), ("int8", 1e-12)):
        jsearch.clear_index_cache()
        tsearch.clear_index_cache()
        want = jsearch.search_index(str(db), str(qf), 0.1, verbose=False,
                                    engine=engine, mesh_devices=8)
        got = tsearch.search_index(str(db), str(qf), 0.1, verbose=False,
                                   engine=engine, mesh_devices=8,
                                   device="cpu")
        index = tsearch._INDEX_CACHE["value"]
        assert isinstance(index, (tdist.DistributedFlatIPIndex,
                                  tdist.DistributedIntExactIndex))
        assert index.mesh.size == 8
        single = tsearch.search_index(str(db), str(qf), 0.1, verbose=False,
                                      engine=engine, device="cpu")
        gm = {(q, i): v for q, i, v in got}
        for ref in (want, single):
            rm = {(q, i): v for q, i, v in ref}
            assert set(rm) == set(gm), engine
            for key in rm:
                assert abs(rm[key] - gm[key]) <= tol, (engine, key)
    jsearch.clear_index_cache()
    tsearch.clear_index_cache()


# ---------------------------------------------------------------------------
# parallel.multihost on one process
# ---------------------------------------------------------------------------

def test_multihost_single_process(monkeypatch, tmp_path, ref_toy_dir):
    assert tmh.host_shards(5) == jmh.host_shards(5) == [0, 1, 2, 3, 4]
    assert tmh.process_info() == jmh.process_info() == (0, 1)
    for var in (tmh.ENV_ADDR, tmh.ENV_PORT, tmh.ENV_COUNT, tmh.ENV_ID):
        monkeypatch.delenv(var, raising=False)
    tmh.initialize(device="cpu")                 # a no-op
    assert not torch.distributed.is_initialized()
    mesh = tmh.global_mesh(device="cpu")
    assert mesh.group is None and mesh.devices == (CPU,)
    folders = tmh.compute_pairwise_multihost(
        str(ref_toy_dir / "toy_db_256"), str(tmp_path / "m"), num_shards=2,
        tile_rows=64, tile_cols=64, verbose=False, device="cpu")
    assert folders == [str(tmp_path / "m" / f"shard_{s}") for s in (0, 1)]


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cuda", "nccl")])
def test_initialize_reads_full_env_triple(monkeypatch, device, backend):
    """Every value of the environment is read, not just the address
    (test_multihost.py's check); the backend follows the device. On CUDA,
    LOCAL_RANK binds the process to its one card, and without it the run
    checks that no two processes share a card."""
    seen = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None):
        seen.update(backend=backend, init=init_method, n=world_size, p=rank)

    monkeypatch.setattr(tmh.dist, "init_process_group", fake_init)
    monkeypatch.setattr(tmh, "resolve_device", torch.device)
    monkeypatch.setattr(tmh, "bind_card", lambda i: seen.update(card=i))
    monkeypatch.setattr(tmh, "_refuse_shared_cards",
                        lambda: seen.update(checked=True))
    monkeypatch.delenv(tmh.ENV_LOCAL, raising=False)
    monkeypatch.setenv(tmh.ENV_ADDR, "h")
    monkeypatch.setenv(tmh.ENV_PORT, "1234")
    monkeypatch.setenv(tmh.ENV_COUNT, "4")
    monkeypatch.setenv(tmh.ENV_ID, "1")
    tmh.initialize(device=device)
    cuda = {"checked": True} if device == "cuda" else {}
    assert seen == {"backend": backend, "init": "tcp://h:1234", "n": 4,
                    "p": 1, **cuda}
    seen.clear()
    monkeypatch.setenv(tmh.ENV_LOCAL, "3")
    tmh.initialize(device=device)
    assert seen.get("card") == (3 if cuda else None)
    assert "checked" not in seen
    monkeypatch.delenv(tmh.ENV_ID)
    with pytest.raises(ValueError, match="process's id"):
        tmh.initialize(device=device)


def test_bound_card_and_shared_cards(monkeypatch):
    """A process bound to its card has that one card as its local devices;
    the shared-card check names each card listed by two processes once."""
    monkeypatch.setattr(_device, "_BOUND_CARD", torch.device("cuda", 3))
    assert _device.local_cards() == [torch.device("cuda", 3)]
    assert _device.local_device_count(torch.device("cuda")) == 1
    assert _device.local_device_count(CPU) == 1
    assert tmh.shared_cards([["a", "b"], ["c"], ["d"]]) == []
    assert tmh.shared_cards([["a", "b"], ["b", "c"], ["c", "b"]]) == ["b",
                                                                       "c"]
    assert tmh.shared_cards([["a", "a"]]) == []        # one process's list
