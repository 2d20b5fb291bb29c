"""The port's int8-plane exact ANN engine (ann/int_index.py) against the
JAX package's on the CPU: (D, I) exactly equal on the JAX tests' grid, with
duplicate ties, k > ntotal, the query-range guard, int16 db folders and the
device-chunk build; the plain scan against the JAX ``_int_scan_pool`` on
identical state; and the selection keys' tie order."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.ann import int_index as jii  # noqa: E402
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu_torch import state  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import int_index as tii  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import select  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402


def _both(V, chunk, **kw):
    return (jii.IntExactIndex(V, chunk_rows=chunk, **kw),
            tii.IntExactIndex(V, chunk_rows=chunk, device="cpu", **kw))


def _assert_same(a, b, Q, k):
    Da, Ia = a.search(Q, k)
    Db, Ib = b.search(Q, k)
    assert Da.dtype == Db.dtype == np.float32
    assert Ia.dtype == Ib.dtype == np.int32
    np.testing.assert_array_equal(Ib, Ia)
    np.testing.assert_array_equal(Db, Da)
    return Db, Ib


@pytest.mark.parametrize("n,d,mag,chunk", [
    (37, 64, 300, 16),       # multi-chunk scan, L=2
    (128, 128, 50, 128),     # single chunk, L=1
    (60, 64, 20000, 32),     # int16-range magnitudes, L=3
])
def test_search_equals_jax(n, d, mag, chunk):
    rng = np.random.default_rng(n + d)
    V = rng.integers(-mag, mag + 1, size=(n, d)).astype(np.int32)
    V[2] = 0                                           # zero row
    Q = rng.integers(-mag, mag + 1, size=(7, d)).astype(np.int32)
    a, b = _both(V, chunk)
    assert b.L == a.L and b.max_abs == a.max_abs
    np.testing.assert_array_equal(b.ns, a.ns)
    _assert_same(a, b, Q, 10)


def test_duplicate_tie_break_equals_jax():
    rng = np.random.default_rng(3)
    V = rng.integers(-100, 101, size=(20, 32)).astype(np.int32)
    V[7] = V[3]
    V[15] = V[3]                                       # across chunks
    a, b = _both(V, 8)
    D, I = _assert_same(a, b, V[3][None], 4)
    assert I[0, :3].tolist() == [3, 7, 15]             # lower index first


def test_k_exceeds_ntotal_equals_jax():
    V = np.arange(12, dtype=np.int32).reshape(3, 4) + 1
    a, b = _both(V, 262144)
    D, I = _assert_same(a, b, np.array([[1, 2, 3, 4]], np.int32), 5)
    assert list(I[0, 3:]) == [-1, -1] and list(D[0, 3:]) == [0.0, 0.0]


def test_query_range_guard_and_float_rejection():
    idx = tii.IntExactIndex(np.ones((4, 8), np.int32) * 50, device="cpu")
    assert idx.L == 1
    with pytest.raises(ValueError, match="limb range"):
        idx.search(np.full((1, 8), 5000, np.int32), 2)
    with pytest.raises(ValueError, match="integer"):
        idx.search(np.ones((1, 8), np.float32), 2)
    with pytest.raises(ValueError, match="integer"):
        tii.IntExactIndex(np.ones((2, 4), np.float32), device="cpu")


@pytest.mark.parametrize("int16", [False, True])
def test_from_dbfolder_equals_jax(tmp_path, int16):
    rng = np.random.default_rng(31 + int16)
    n, d, mag = 50, 64, 20000 if int16 else 800
    V = rng.integers(-mag, mag + 1, size=(n, d)).astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d, use_int16=int16)
    Q = rng.integers(-mag, mag + 1, size=(4, d)).astype(np.int32)
    a = jii.IntExactIndex.from_dbfolder(db.path, chunk_rows=16)
    b = tii.IntExactIndex.from_dbfolder(db.path, chunk_rows=16, device="cpu")
    assert b.L == a.L and (b.L >= 3) == int16
    np.testing.assert_array_equal(b.ns, a.ns)
    _assert_same(a, b, Q, 8)


def test_from_device_chunks_equals_host_build():
    rng = np.random.default_rng(13)
    n, d, R = 70, 64, 32
    V = rng.integers(-900, 901, size=(n, d)).astype(np.int32)
    V[5] = 0
    Q = rng.integers(-900, 901, size=(3, d)).astype(np.int32)
    host = tii.IntExactIndex(V, chunk_rows=R, device="cpu")
    chunks = [(s, torch.from_numpy(V[s:s + R])) for s in range(0, n, R)]
    dev = tii.IntExactIndex.from_device_chunks(chunks, d)
    assert len(chunks) == 0                            # consumed
    assert dev.ntotal == n and dev.L == host.L and dev.chunk_rows == R
    np.testing.assert_array_equal(dev.ns, host.ns)
    assert torch.equal(dev._stack, host._stack)
    _assert_same(host, dev, Q, 9)


@pytest.mark.parametrize("pool", [5, 40, 70])
def test_plain_scan_equals_jax_int_scan_pool(pool):
    """Identical state (state.int_index_from_reference) -> the same pooled
    index sets, and the port's kernel X partials recombine to the exact
    dots the JAX engine's per-plane partials give."""
    import jax.numpy as jnp
    rng = np.random.default_rng(41)
    n, d, R = 70, 96, 32
    V = rng.integers(-2000, 2001, size=(n, d)).astype(np.int32)
    Q = rng.integers(-2000, 2001, size=(5, d)).astype(np.int32)
    ref = jii.IntExactIndex(V, chunk_rows=R)
    port = state.int_index_from_reference(
        np.asarray(ref._stack), ref.ns, ref.L, ref.chunk_rows, ref._shape,
        device="cpu")
    qp = jnp.asarray(jii._host_planes(Q, ref.L))
    _, ji, jp = jii._int_scan_pool(qp, ref._stack, ref._inv_n, n, pool)
    ji, jp = np.asarray(ji), np.asarray(jp).astype(np.int64)
    jdots = np.einsum("p,pbk->bk", pm.plane_weights_int(ref.L), jp)
    _, ti, tp = tii._int_scan_pool(tii.query_planes(Q, port.L, "cpu"), 5,
                                   port._stack, port._inv_n, n, R, pool,
                                   port.L, pw.range_flag("cpu"),
                                   *tii.chunk_layout(port._stack.shape[0], R,
                                                     n))
    ti, tp = ti.numpy(), tp.numpy()
    assert ti.shape == ji.shape == (5, min(pool, n))
    tdots = pm.combine_plane_partials(tp.reshape(-1, tp.shape[2]).T,
                                      port.L).reshape(ti.shape)
    exact = Q.astype(np.int64) @ V.astype(np.int64).T
    for b in range(5):
        assert set(ti[b].tolist()) == set(ji[b].tolist())
        np.testing.assert_array_equal(tdots[b], exact[b, ti[b]])
        np.testing.assert_array_equal(jdots[b], exact[b, ji[b]])


def test_scan_scores_plain_masks_and_scales():
    rng = np.random.default_rng(5)
    L = 2
    planes = torch.zeros((3, 40, 64), dtype=torch.int8)
    V = torch.from_numpy(rng.integers(-500, 501, size=(40, 64))
                         .astype(np.int32))
    pw.planes_update(planes, pw.decompose_limbs(V, L), 0)
    inv = torch.from_numpy(rng.random(40).astype(np.float32))
    s = pw.scan_scores(planes[:, :6], planes, inv, 33)
    assert s.shape == (6, 40) and bool(torch.isinf(s[:, 33:]).all())
    want = pw.approx_dot_f32(planes[:, :6], planes) * inv[None, :]
    assert torch.equal(s[:, :33], want[:, :33])
    parts = pw.pair_partials(planes[:, :6], torch.tensor(
        [[0, 5], [5, 39]], dtype=torch.int32), L, planes)
    dots = pm.combine_plane_partials(parts.numpy().T, L)
    Vn = V.numpy().astype(np.int64)
    assert dots.tolist() == [int(Vn[0] @ Vn[5]), int(Vn[5] @ Vn[39])]


def test_rank_keys_order_ties_by_lowest_index():
    s = torch.tensor([[1.0, -0.0, 0.0, -2.5, float("-inf"), 3.0, 1.0,
                       -1e-30]])
    keys = select.rank_keys(s, torch.arange(8))
    top, _ = torch.topk(keys, 8)
    order = [5, 0, 6, 1, 2, 7, 3, 4]
    assert select.key_index(top).tolist() == [order]
    assert torch.equal(select.key_scores(top), s[:, order] + 0.0)
    assert torch.equal(select.key_scores(select.rank_keys(
        s, torch.arange(8))), s + 0.0)


def test_from_dbfolder_rejects_stale_max(tmp_path):
    V = np.random.default_rng(0).integers(-500, 501, size=(20, 64)) \
        .astype(np.int32)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(20)],
                        V, 64)
    (tmp_path / "db" / "max_component.txt").write_text("3\n")
    with pytest.raises(ValueError, match="stale"):
        tii.IntExactIndex.from_dbfolder(db.path, device="cpu")
