"""Kernel K's function (ann/select.py) on the CPU, through its plain
versions, against the JAX package: the int8 engine's ``_int_scan_pool`` in
index order, scores and exactly recombined partials, in both of JAX's
selection regimes (two-stage over 128-lane blocks and plain lax.top_k) on
exact-tie grids; the f32 engine's ``_scan_topk`` on rows duplicated across
chunks; ``select_keys_plain`` against an independent oracle. The CUDA
kernel itself is held against these plain versions in
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from metagenome_vector_sketches_tpu.ann import flat_index as jfi  # noqa: E402
from metagenome_vector_sketches_tpu.ann import int_index as jii  # noqa: E402
from metagenome_vector_sketches_tpu_torch import state  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import flat_index as tfi  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import int_index as tii  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import select as sel  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402


def _tie_grid_vectors(R, d, seed):
    """Integer vectors built from FEW prototypes so scores form large
    exact-tie classes scattered across 128-blocks; prototypes are small
    enough for L=1 (single plane, so the f32 device score is exactly
    reproducible in numpy)."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(-4, 5, size=(8, d)).astype(np.int32)
    assign = rng.integers(0, 8, size=R)
    V = protos[assign]
    # hand-placed duplicates straddling 128-block boundaries
    V[120:136] = protos[0]
    V[255:258] = protos[1]
    V[1023:1026] = protos[2]
    return V


def _both_pools(V, Q, R, pool):
    """JAX ``_int_scan_pool`` and the port's on identical state -> (JAX
    (scores, indices, exact dots), port's (the same))."""
    n = len(V)
    ref = jii.IntExactIndex(V, chunk_rows=R)
    port = state.int_index_from_reference(
        np.asarray(ref._stack), ref.ns, ref.L, ref.chunk_rows, ref._shape,
        device="cpu")
    qp = jnp.asarray(jii._host_planes(Q, ref.L))
    js, ji, jp = (np.asarray(x) for x in
                  jii._int_scan_pool(qp, ref._stack, ref._inv_n, n, pool))
    jdots = np.einsum("p,pbk->bk", pm.plane_weights_int(ref.L),
                      jp.astype(np.int64))
    ts, ti, tp = tii._int_scan_pool(
        tii.query_planes(Q, port.L, "cpu"), len(Q), port._stack,
        port._inv_n, n, R, pool, port.L, pw.range_flag("cpu"),
        *tii.chunk_layout(port._stack.shape[0], R, n))
    ts, ti, tp = ts.numpy(), ti.numpy(), tp.numpy()
    tdots = pm.combine_plane_partials(tp.reshape(-1, tp.shape[2]).T,
                                      port.L).reshape(ti.shape)
    return (js, ji, jdots), (ts, ti, tdots)


def _assert_same_pools(V, Q, R, pool):
    (js, ji, jd), (ts, ti, td) = _both_pools(V, Q, R, pool)
    assert ti.shape == ji.shape == (len(Q), min(pool, -(-len(V) // R) * R))
    np.testing.assert_array_equal(ti, ji)                # order, not sets
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    exact = Q.astype(np.int64) @ V.astype(np.int64).T
    ok = ti >= 0
    np.testing.assert_array_equal(
        td[ok], np.take_along_axis(exact, np.maximum(ti, 0), 1)[ok])
    np.testing.assert_array_equal(td[~ok], 0)
    return ti, ts


def _tie_queries(V, d, seed):
    return np.concatenate([V[[120, 255, 1023, 0]],
                           np.random.default_rng(seed).integers(
                               -4, 5, size=(4, d))]).astype(np.int32)


@pytest.mark.parametrize("pool", [1, 7, 16])
def test_int_scan_pool_two_stage_regime_equals_jax(pool):
    """R = 2048, kc <= R/128: JAX's two-stage selector; the pool's cut
    falls inside a tie class for the self-queries."""
    R, d = 2048, 16
    V = _tie_grid_vectors(R, d, 70)
    Q = _tie_queries(V, d, 71)
    ti, ts = _assert_same_pools(V, Q, R, pool)
    if pool > 1:
        assert any((ts[b] == ts[b][-1]).sum() > 1 for b in range(3))


@pytest.mark.parametrize("pool", [2048 // 128 + 1, 2100])
def test_int_scan_pool_top_k_regime_equals_jax(pool):
    """kc > R/128 (JAX's plain lax.top_k per chunk), and a pool above R:
    two chunks, the second uneven, so the pool holds no-row entries."""
    R, d = 2048, 16
    V = np.concatenate([_tie_grid_vectors(R, d, 72),
                        _tie_grid_vectors(R, d, 73)[:R // 2 + 3]])
    Q = _tie_queries(V, d, 74)
    ti, _ = _assert_same_pools(V, Q, R, pool)
    if pool > R:
        assert (ti[:, :len(V)] >= 0).all() and (ti[:, len(V):] == -1).all()


@pytest.mark.parametrize("pool", [5, 40])
def test_int_scan_pool_uneven_chunks_two_limbs_equals_jax(pool):
    """L = 2 planes over three chunks, the last one short: the pooled
    order, scores and exact dots equal JAX's."""
    rng = np.random.default_rng(43)
    V = rng.integers(-2000, 2001, size=(300, 64)).astype(np.int32)
    V[200:210] = V[5]                                   # ties across chunks
    Q = np.concatenate([V[[5]], rng.integers(-2000, 2001, size=(4, 64))]) \
        .astype(np.int32)
    ti, _ = _assert_same_pools(V, Q, 128, pool)
    assert ti[0, :11].tolist() == ([5] + list(range(200, 210)))[:pool]


@pytest.mark.parametrize("k", [1, 9, 40])
def test_flat_scan_topk_ties_equal_jax(k):
    """The f32 engine's selection against JAX ``_scan_topk``: rows
    duplicated across chunks, exactly representable products (so both
    frameworks' sums are exact), an uneven last chunk."""
    rng = np.random.default_rng(k)
    n, d, R = 150, 32, 64
    V = (rng.integers(-2, 3, size=(n, d)) / 2).astype(np.float32)
    V[[70, 130, 149]] = V[3]
    V[[64, 65]] = V[63]
    Q = np.concatenate([V[[3, 63]], (rng.integers(-2, 3, size=(3, d)) / 2)
                        ]).astype(np.float32)
    C = -(-n // R)
    stack = np.zeros((C * R, d), dtype=np.float32)
    stack[:n] = V
    jd, ji = jfi._scan_topk(jnp.asarray(Q), jnp.asarray(stack.reshape(C, R, d)),
                            n, k)
    chunks = [(s, torch.from_numpy(V[s:s + R])) for s in range(0, n, R)]
    td, ti = tfi._scan_topk(torch.from_numpy(Q), chunks, n, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if k >= 4:
        assert ti[0, :4].tolist() == [3, 70, 130, 149]
        assert ti[1, :3].tolist() == [63, 64, 65]


@pytest.mark.parametrize("W,k", [(1, 3), (50, 50), (300, 17), (1000, 999)])
def test_select_keys_plain_equals_lexsort_oracle(W, k):
    """Best keys first, equal keys (the no-row index) in position order,
    against a numpy lexsort over (key descending, position ascending)."""
    rng = np.random.default_rng(W)
    s = torch.from_numpy((rng.integers(-3, 4, size=(4, W)) / 2)
                         .astype(np.float32))
    s[0, ::3] = float("-inf")
    idx = torch.from_numpy(rng.integers(0, 20, size=(4, W)))
    keys = sel.rank_keys(s, idx)
    top, pos = sel.select_keys_plain(keys, k)
    kn = keys.numpy()
    kk = min(k, W)
    for b in range(4):
        order = np.lexsort((np.arange(W), -(kn[b] & 1), -(kn[b] >> 1)))
        assert pos[b].tolist() == order[:kk].tolist()
        assert top[b].tolist() == kn[b][order[:kk]].tolist()


def test_select_chunk_plain_lanes_and_merge_positions():
    """The chunk's top keys decode to (score, base + lane) with no-row
    lanes past valid; the merge's positions index cat([best, chunk top])
    with the pool first among equal keys."""
    s = torch.tensor([[0.5, 2.0, -0.0, 2.0, 1.0, 3.0]])
    best = sel.rank_keys(torch.tensor([[3.0, 2.0]]), torch.tensor([[50, 0]]))
    keys, lanes, merged, pos = sel.select_chunk_plain(
        s, 10, 4, 99, 5, best, 6)
    assert lanes.tolist() == [[5, 1, 3, 4, 0]]
    assert sel.key_index(keys).tolist() == [[99, 11, 13, 99, 10]]
    assert sel.key_scores(keys).tolist() == [[3.0, 2.0, 2.0, 1.0, 0.5]]
    assert pos.tolist() == [[0, 2, 1, 3, 4, 5]]
    assert torch.equal(merged, torch.cat([best, keys], 1)[0, pos[0]][None])


def test_select_routes_cpu_tensors_to_the_plain_versions(monkeypatch):
    """CPU tensors never reach the kernel library (there is none here)."""
    from metagenome_vector_sketches_tpu_torch import _build

    def refuse():
        raise AssertionError("the kernel library was asked for")

    monkeypatch.setattr(_build, "library", refuse)
    s = torch.randn(3, 300)
    empty = torch.empty((3, 0), dtype=torch.int64)
    got = sel.select_chunk(s, 0, 300, 300, 4, empty, 4)
    assert all(torch.equal(g, w) for g, w in zip(
        got, sel.select_chunk_plain(s, 0, 300, 300, 4, empty, 4)))
    assert torch.equal(sel.select_keys(got[0], 2)[1],
                       torch.tensor([[0, 1]] * 3))


@pytest.mark.parametrize("kc,W,two", [(1, 2048, True), (15, 2048, True),
                                      (16, 2048, False), (2, 300, True),
                                      (3, 300, False), (1, 256, True),
                                      (2, 256, False),
                                      (2048, 10 ** 6, True),
                                      (2049, 10 ** 6, False)])
def test_two_stage_choice_by_shape(kc, W, two):
    """The two-stage selection runs when it cuts blocks and its chosen
    blocks fit a row CTA's shared memory."""
    assert sel._two_stage(kc, W) == two


# kernel K's regime at each adaptive level's chunk kc = min(pool_for(50 *
# 3^level), R) (levels 0-8), for chunks of 262,144 and 65,536 rows
_LEVEL_REGIMES = {
    262144: ["two_stage"] * 4 + ["radix"] * 4 + ["full"],
    65536: ["two_stage"] * 2 + ["radix"] * 5 + ["full"] * 2,
}


@pytest.mark.parametrize("level", range(9))
@pytest.mark.parametrize("R", sorted(_LEVEL_REGIMES))
def test_regime_at_each_adaptive_level(R, level):
    """The adaptive search's chunk kc at every level lands in the regime
    the kernel's design gives it: two-stage while the kc best 128-lane
    blocks cut the row and fit the row stage, the multi-CTA radix select
    past that, the grid-wide sort of every lane at kc = R."""
    from types import SimpleNamespace
    idx = SimpleNamespace(pool_margin=64, ntotal=10 ** 7)
    kc = min(tii.IntExactIndex.pool_for(idx, 50 * 3 ** level), R)
    assert kc == min(R, [114, 214, 514, 1518, 4556, 13668, 41006, 123018,
                         369056][level])
    assert sel.regime(kc, R) == _LEVEL_REGIMES[R][level]
    assert sel.regime(kc, R) in sel.REGIMES


@pytest.mark.parametrize("kc,W,want", [(114, 228, "row"), (50, 100, "row"),
                                       (2048, 16384, "row"),
                                       (2048, 16385, "radix"),
                                       (2049, 9000, "radix"),
                                       (9000, 9000, "full"),
                                       (1, 1, "row"), (50, 7000, "two_stage"),
                                       (2048, 10 ** 6, "two_stage")])
def test_regime_of_small_and_wide_rows(kc, W, want):
    """Re-selections of small rows (a merge's width, the f32 rescoring) stay
    on one CTA a row; wider rows that the block maxima cannot cut go to the
    multi-CTA radix select; kc = W is the full sort."""
    assert sel.regime(kc, W) == want


@pytest.mark.parametrize("bad", ["kc0", "kc_big", "dtype", "stride",
                                 "base", "best"])
def test_launch_checks_its_inputs(bad):
    """Kernel K's wrapper refuses what the kernel does not take before any
    launch (checked here on CPU tensors: it raises before the library)."""
    s = torch.zeros(2, 64)
    kw = dict(rows=s, kc=3)
    if bad == "kc0":
        kw["kc"] = 0
    elif bad == "kc_big":
        kw["kc"] = 65
    elif bad == "dtype":
        kw["rows"] = s.double()
    elif bad == "stride":
        kw["rows"] = s.t()
    elif bad == "base":
        kw.update(base=2 ** 32 - 10, valid=64)
    else:
        kw.update(best=torch.zeros(2, 4), pool=4)
    with pytest.raises(ValueError):
        sel._launch(**kw)
