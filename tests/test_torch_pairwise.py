"""The port's device ops (plain PyTorch path on the CPU) against the JAX
package: Karatsuba planes, the K1 sweep counts (the Pallas kernel in
interpreter mode and the XLA scan), the fused sweep's survivor sets, and
the exact limb-pair partials.

Tolerance: integer outputs (planes, partials, counts, survivor sets) are
exact. The float32 combine values themselves are not compared with JAX
(XLA reorders and contracts them); masks are. Should a seed ever put a
pair on the retention boundary, :func:`assert_masks_agree` allows a
differing pair only within ``required_slack_abs`` of the threshold,
measured with exact int64 dots — the one place that rule is written.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from metagenome_vector_sketches_tpu.ops import pairwise as ref  # noqa: E402
from metagenome_vector_sketches_tpu.ops.pallas_pairwise import (  # noqa: E402
    pallas_sweep_counts)
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops.pallas_pairwise import (  # noqa: E402
    sweep_counts, sweep_counts_plain)
from metagenome_vector_sketches_tpu_torch.state import (  # noqa: E402
    from_reference_state)

N, D = 128, 100          # d = 100 pads to d_pad = 128 in the port


def _db(max_abs, seed, n=N, d=D):
    """Random db with planted near-duplicates; thresholds = |v|^2 / d (the
    JAX kernel tests' convention), so a sizeable share of pairs passes."""
    rng = np.random.default_rng(seed)
    V = rng.integers(-max_abs, max_abs + 1, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    V[20:30] = np.clip(V[19] + rng.integers(-2, 3, size=(10, d)),
                       -max_abs, max_abs)
    thr = (np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
           / d).astype(np.float32)
    L = pm.pick_limbs(max_abs)
    jplanes = np.asarray(ref.decompose_planes(jnp.asarray(V), L))
    planes, thr_t = from_reference_state(jplanes, thr, "cpu")
    return V, L, jplanes, thr, planes, thr_t


def assert_masks_agree(got, want, V, thr, d, L, max_abs, rows, cols):
    """got/want: bool survivor masks over V[rows] x V[cols]. Equal, or
    every differing pair lies within the certified float32 slack of the
    threshold (exact int64 dots)."""
    got, want = np.asarray(got, bool), np.asarray(want, bool)
    diff = np.argwhere(got != want)
    if len(diff) == 0:
        return
    r, c = rows[diff[:, 0]], cols[diff[:, 1]]
    exact = np.einsum("kd,kd->k", V[r].astype(np.int64),
                      V[c].astype(np.int64)) / d
    t = 0.05 * (thr[r].astype(np.float64) + thr[c]) * float(pm.SLACK_REL) \
        - float(pm.SLACK_ABS)
    slack = pm.required_slack_abs(L, max_abs, d)
    assert np.all(np.abs(exact - t) <= slack), \
        f"{len(diff)} mask differences beyond the certified slack {slack}"


def _jax_mask(jplanes, thr, d, rows, cols):
    """The JAX package's float32 sweep mask (its approx_dot_f32 + its
    threshold expression) over rows x cols."""
    approx = np.asarray(ref.approx_dot_f32(jnp.asarray(jplanes[:, rows]),
                                           jnp.asarray(jplanes[:, cols])))
    return approx / np.float32(d) > \
        0.05 * (thr[rows][:, None] + thr[cols][None, :]) * ref.SLACK_REL \
        - ref.SLACK_ABS


@pytest.mark.parametrize("max_abs", [100, 3000, 30000])
def test_planes_match_decompose_planes(max_abs):
    rng = np.random.default_rng(max_abs)
    V = rng.integers(-max_abs, max_abs + 1, size=(40, D)).astype(np.int32)
    V[0, :2] = [max_abs, -max_abs]
    L = pm.pick_limbs(max_abs)
    want = np.asarray(ref.decompose_planes(jnp.asarray(V), L))
    limbs = pw.decompose_limbs(torch.from_numpy(V), L)
    np.testing.assert_array_equal(
        limbs.numpy(), np.asarray(ref.decompose_limbs(jnp.asarray(V), L)))
    np.testing.assert_array_equal(pw.karatsuba_planes(limbs).numpy(), want)
    buf = torch.zeros((pm.num_planes(L), 64, pw.pad_dim(D)),
                      dtype=torch.int8)
    pw.planes_update(buf, limbs[:, :30], 0)
    pw.planes_update(buf, limbs[:, 30:], 30)
    np.testing.assert_array_equal(buf[:, :40, :D].numpy(), want)
    assert not buf[:, 40:].any() and not buf[:, :, D:].any()


@pytest.mark.parametrize("max_abs,P", [(300, 3), (30000, 6)])
@pytest.mark.parametrize("grid", ["symmetric", "asymmetric", "row_window"])
def test_sweep_counts_match_pallas_and_xla(max_abs, P, grid):
    V, L, jplanes, thr, planes, thr_t = _db(max_abs, seed=P)
    assert planes.shape[0] == P
    kw = {"symmetric": dict(block=32),
          "asymmetric": dict(block=32, block_j=16),
          "row_window": dict(row_t0=1, row_t1=3, block=32, block_j=16)}[grid]
    got = sweep_counts(planes, thr_t, D, **kw).numpy()
    want = np.asarray(pallas_sweep_counts(jnp.asarray(jplanes),
                                          jnp.asarray(thr), interpret=True,
                                          **kw))
    assert got.shape == want.shape and got.sum() > 1000
    if not np.array_equal(got, want):
        # boundary pairs only: compare the masks pair by pair
        rows = np.arange(kw.get("row_t0", 0) * 32,
                         kw.get("row_t1", N // 32) * 32)
        cols = np.arange(N)
        mask = pw.retention_mask(pw.approx_dot_f32(planes[:, rows], planes),
                                 thr_t[rows], thr_t, D).numpy()
        assert_masks_agree(mask, _jax_mask(jplanes, thr, D, rows, cols), V,
                           thr, D, L, max_abs, rows, cols)
    if grid == "symmetric":
        nt = N // 32
        coords = np.array([(r, c) for r in range(nt) for c in range(nt)],
                          dtype=np.int32)
        xla = np.asarray(ref.sweep_counts(jnp.asarray(jplanes),
                                          jnp.asarray(thr),
                                          jnp.asarray(coords), 32))
        np.testing.assert_array_equal(got.reshape(-1), xla)


def test_sweep_counts_plain_is_the_cpu_path():
    _, _, _, _, planes, thr_t = _db(300, seed=9)
    np.testing.assert_array_equal(
        sweep_counts(planes, thr_t, D, block=64).numpy(),
        sweep_counts_plain(planes, thr_t, D, block=64).numpy())
    with pytest.raises(ValueError):
        sweep_counts(planes, thr_t, D, block=48)        # 128 % 48 != 0
    with pytest.raises(ValueError):
        sweep_counts(planes, thr_t, D, row_t0=2, row_t1=5, block=64)


def _tiles_as(coords, call):
    """The tiles ``coords`` as sweep_extract takes them: the (K, 2) array,
    a TileList, or the range of a longer TileList that holds them between
    other tiles."""
    if call == "array":
        return coords
    if call == "tile_list":
        return pw.TileList(coords, "cpu")
    pad = np.array([(0, 0), (1, 2)], dtype=np.int32)
    longer = pw.TileList(np.concatenate([pad, coords, pad]), "cpu")
    return longer[len(pad):len(pad) + len(coords)]


def _fused_ij_pairs(jplanes_i, thr_i, jplanes_j, thr_j, coords, bases, tile,
                    L):
    """JAX sweep_extract_fused_ij's survivors -> ({operand-local (row,
    column): partials}, per-tile counts)."""
    jcoords = np.concatenate([coords, np.ones((len(coords), 1), np.int32)],
                             1)
    cand, parts, jcounts = ref.sweep_extract_fused_ij(
        jnp.asarray(jplanes_i), jnp.asarray(thr_i), jnp.asarray(jplanes_j),
        jnp.asarray(thr_j), jnp.asarray(jcoords), jnp.asarray(bases), tile,
        L, tile * tile)
    cand, parts = np.asarray(cand), np.asarray(parts)
    want = {}
    for k, (r, c) in enumerate(coords):
        ok = cand[k] >= 0
        for idx, p in zip(cand[k][ok], parts[k][ok]):
            want[(r * tile + idx // tile, c * tile + idx % tile)] = tuple(p)
    return want, np.asarray(jcounts)


@pytest.mark.parametrize("call", ["array", "tile_list", "range"])
@pytest.mark.parametrize("max_abs", [300, 30000])
def test_sweep_extract_matches_fused_ij(max_abs, call):
    """Survivor sets, per-tile counts and partials equal
    sweep_extract_fused_ij's (self-pairs masked) on a triangle grid, at
    P = 3 and 6 (an int16-range max_abs), the tiles given as an array, a
    TileList and a range of a longer one."""
    V, L, jplanes, thr, planes, thr_t = _db(max_abs, seed=11)
    tile = 32
    nt = N // tile
    coords = np.array([(r, c) for r in range(nt) for c in range(r, nt)],
                      dtype=np.int32)
    cand, parts, jcounts = ref.sweep_extract_fused(
        jnp.asarray(jplanes), jnp.asarray(thr),
        jnp.asarray(np.concatenate([coords, np.ones((len(coords), 1),
                                                    np.int32)], 1)),
        tile, L, tile * tile)
    cand, parts, jcounts = (np.asarray(cand), np.asarray(parts),
                            np.asarray(jcounts))
    want = {}
    for k, (r, c) in enumerate(coords):
        ok = cand[k] >= 0
        for idx, p in zip(cand[k][ok], parts[k][ok]):
            want[(r * tile + idx // tile, c * tile + idx % tile)] = tuple(p)

    rc, counts, total = pw.sweep_extract(planes, thr_t, planes, thr_t,
                                         _tiles_as(coords, call), tile,
                                         100000, True, D)
    n = int(total.item())
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    assert n == len(want) == int(jcounts.sum()) and n > 500
    got_pairs = [tuple(x) for x in rc[:n].tolist()]
    assert set(got_pairs) == set(want)
    got_parts = pw.pair_partials(planes, rc[:n], L).numpy()
    for pair, p in zip(got_pairs, got_parts):
        assert tuple(p) == want[pair]


@pytest.mark.parametrize("call", ["tile_list", "range"])
@pytest.mark.parametrize("offset", [32, -32])
@pytest.mark.parametrize("max_abs", [300, 30000])
def test_sweep_extract_two_operands_match_fused_ij(max_abs, offset, call):
    """Two windows of one db (rows 32.. and 32 + offset..) as the sweep's
    two operands, the self mask at diag_offset = offset: survivor sets,
    per-tile counts and two-operand partials equal sweep_extract_fused_ij's
    with the windows' global bases, at P = 3 and 6."""
    V, L, jplanes, thr, planes, thr_t = _db(max_abs, seed=13)
    tile, w, a = 32, 64, 32
    b = a + offset
    coords = np.array([(r, c) for r in range(w // tile)
                       for c in range(w // tile)], dtype=np.int32)
    want, jcounts = _fused_ij_pairs(
        jplanes[:, a:a + w], thr[a:a + w], jplanes[:, b:b + w],
        thr[b:b + w], coords, coords * tile + np.array([a, b], np.int32),
        tile, L)
    pi, ti = planes[:, a:a + w].contiguous(), thr_t[a:a + w].contiguous()
    pj, tj = planes[:, b:b + w].contiguous(), thr_t[b:b + w].contiguous()
    rc, counts, total = pw.sweep_extract(pi, ti, pj, tj,
                                         _tiles_as(coords, call), tile,
                                         10000, True, D, offset)
    n = int(total.item())
    np.testing.assert_array_equal(counts.numpy(), jcounts)
    assert n == len(want) == int(jcounts.sum()) and n > 0
    got_pairs = [tuple(x) for x in rc[:n].tolist()]
    assert set(got_pairs) == set(want)
    assert not any(r + a == c + b for r, c in got_pairs)
    got_parts = pw.pair_partials(pi, rc[:n], L, pj).numpy()
    for pair, p in zip(got_pairs, got_parts):
        assert tuple(p) == want[pair]


def test_sweep_extract_cap_keeps_counting():
    """Past its capacity the sweep writes the first `cap` survivors and
    still returns the exact total and per-tile counts."""
    _, _, _, _, planes, thr_t = _db(300, seed=12)
    coords = np.array([(0, 0), (0, 1), (1, 3)], dtype=np.int32)
    rc, counts, total = pw.sweep_extract(planes, thr_t, planes, thr_t,
                                         coords, 32, 5000, True, D)
    n = int(total.item())
    rc_s, counts_s, total_s = pw.sweep_extract(planes, thr_t, planes, thr_t,
                                               coords, 32, n // 2, True, D)
    assert int(total_s.item()) == n and torch.equal(counts, counts_s)
    assert torch.equal(rc_s, rc[:n // 2])


@pytest.mark.parametrize("max_abs", [100, 3000, 30000, 2000000])
def test_pair_partials_match_plane_partial_dots(max_abs):
    rng = np.random.default_rng(max_abs % 97)
    V = rng.integers(-max_abs, max_abs + 1, size=(64, D)).astype(np.int32)
    L = pm.pick_limbs(max_abs)
    jplanes = np.asarray(ref.decompose_planes(jnp.asarray(V), L))
    planes, _ = from_reference_state(jplanes, np.zeros(64, np.float32),
                                     "cpu")
    r = rng.integers(0, 64, size=300).astype(np.int32)
    c = rng.integers(0, 64, size=300).astype(np.int32)
    c[:5] = r[:5]                                       # self pairs
    got = pw.pair_partials(planes, torch.from_numpy(np.stack([r, c], 1)), L)
    want = np.asarray(ref.plane_partial_dots(jnp.asarray(jplanes),
                                             jnp.asarray(r), jnp.asarray(c),
                                             L))
    np.testing.assert_array_equal(got.numpy().T, want)
    np.testing.assert_array_equal(
        pm.combine_plane_partials(got.numpy().T, L),
        np.einsum("kd,kd->k", V[r].astype(np.int64), V[c].astype(np.int64)))


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
def test_pair_partials_limbs_match_plane_partial_dots(L):
    """L = 1..5 limb planes (any int8): one operand against
    plane_partial_dots; two operands against plane_partial_dots on the
    two operands' rows concatenated."""
    rng = np.random.default_rng(L)
    P, d_pad = pm.num_planes(L), 64
    x = rng.integers(-128, 128, size=(P, 40, d_pad), dtype=np.int8)
    y = rng.integers(-128, 128, size=(P, 70, d_pad), dtype=np.int8)
    r = rng.integers(0, 40, size=257).astype(np.int32)
    c = rng.integers(0, 40, size=257).astype(np.int32)
    r[100:] = r[0]                                      # repeated rows
    got = pw.pair_partials(torch.from_numpy(x),
                           torch.from_numpy(np.stack([r, c], 1)), L)
    want = np.asarray(ref.plane_partial_dots(jnp.asarray(x), jnp.asarray(r),
                                             jnp.asarray(c), L))
    np.testing.assert_array_equal(got.numpy().T, want)
    c2 = rng.integers(0, 70, size=257).astype(np.int32)
    got2 = pw.pair_partials(torch.from_numpy(x),
                            torch.from_numpy(np.stack([r, c2], 1)), L,
                            torch.from_numpy(y))
    want2 = np.asarray(ref.plane_partial_dots(
        jnp.asarray(np.concatenate([x, y], axis=1)), jnp.asarray(r),
        jnp.asarray(c2 + 40), L))
    np.testing.assert_array_equal(got2.numpy().T, want2)


@pytest.mark.parametrize("bad", [[40, 0], [0, -1], [-3, 2], [0, 70]])
def test_pair_partials_rejects_out_of_range_pairs(bad):
    """A candidate outside [0, rows of planes) x [0, rows of planes_j)
    raises ValueError (kernel X counts it into its range flag instead,
    read where the caller synchronises)."""
    x = torch.zeros((3, 40, 16), dtype=torch.int8)
    y = torch.zeros((3, 70, 16), dtype=torch.int8)
    rc = torch.tensor([[0, 1], bad], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        pw.pair_partials(x, rc, 2, y)
    flag = pw.range_flag("cpu")
    assert torch.equal(pw.pair_partials(x, rc[:1], 2, y, flag),
                       pw.pair_partials_plain(x, rc[:1], 2, y))
    pw.check_range_flag(flag)
    flag += 2
    with pytest.raises(ValueError, match="2 candidate pair"):
        pw.check_range_flag(flag)
