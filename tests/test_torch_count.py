"""Kernel COUNT's contract (ops/pallas_pairwise.py: sweep_counts,
count_tiles, TileList; plain PyTorch path on the CPU) against the JAX
package's one Pallas kernel, ``pallas_sweep_counts``, in interpret mode.

Kernel COUNT splits every tile into work items of 256 x 256 (a 2 x 2
cluster of 128 x 128 CTA tiles): the edges below give 1, 2 and 4 items a
tile, and 384 an odd multiple of 128 (items with a dead half). On the CPU
the plain version runs; the GPU tests (tests/test_torch_gpu.py) hold the
kernel against it at these splits. Integer sums do not depend on the
split: any sub-block split of a tile gives the tile's count.

Tolerance: exact (integer counts).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from metagenome_vector_sketches_tpu.ops import pairwise as jpw  # noqa: E402
from metagenome_vector_sketches_tpu.ops.pallas_pairwise import (  # noqa: E402
    pallas_sweep_counts)
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp  # noqa: E402
from metagenome_vector_sketches_tpu_torch.parallel.engine import (  # noqa: E402
    MeshSweepOps)
from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh  # noqa: E402

N, D = 1024, 64
# max |component| giving P = 1, 3 and 6 planes (L = 1, 2, 3)
MAX_ABS = {1: 40, 3: 3000, 6: 30000}


def _state(P, n=N, d=D, seed=0):
    """Random db with planted near-duplicates -> (JAX planes, thresholds,
    the port's planes, thresholds): thresholds |v|^2 / d, so a sizeable
    share of the pairs passes."""
    m = MAX_ABS[P]
    rng = np.random.default_rng(seed + P)
    V = rng.integers(-m, m + 1, size=(n, d)).astype(np.int32)
    V[1:4] = V[0]
    V[300:340] = np.clip(V[299] + rng.integers(-2, 3, size=(40, d)), -m, m)
    V[700:720] = V[300]
    L = pm.pick_limbs(m)
    assert pm.num_planes(L) == P
    thr = (np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
           / d).astype(np.float32)
    planes = torch.zeros((P, n, pw.pad_dim(d)), dtype=torch.int8)
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V), L), 0)
    return jpw.decompose_planes(jnp.asarray(V), L), thr, planes, \
        torch.from_numpy(thr)


def _pallas(jplanes, thr, block, block_j, row_t0=0, row_t1=None):
    return np.asarray(pallas_sweep_counts(
        jplanes, jnp.asarray(thr), row_t0=row_t0, row_t1=row_t1, block=block,
        block_j=block_j, interpret=True))


# (row edge, column edge): 1, 2 and 4 work items of 256 x 256 a tile
EDGES = [(256, 256), (256, 512), (512, 512)]


@pytest.mark.parametrize("edges", EDGES, ids=["1item", "2items", "4items"])
@pytest.mark.parametrize("P", [1, 3, 6])
def test_sweep_counts_match_pallas(P, edges):
    """sweep_counts (pallas_sweep_counts' contract: row tiles [row_t0,
    row_t1) x every column tile) equals the Pallas kernel, over the whole
    grid and over the last row tile."""
    jplanes, thr, planes, t = _state(P)
    block, block_j = edges
    want = _pallas(jplanes, thr, block, block_j)
    got = pp.sweep_counts(planes, t, D, block=block, block_j=block_j)
    assert got.dtype == torch.int32 and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)
    last = N // block - 1
    np.testing.assert_array_equal(
        pp.sweep_counts(planes, t, D, last, last + 1, block,
                        block_j).numpy(),
        _pallas(jplanes, thr, block, block_j, last, last + 1))


@pytest.mark.parametrize("tile", [256, 384, 512],
                         ids=["1item", "4items_odd", "4items"])
@pytest.mark.parametrize("P", [1, 3, 6])
def test_count_tiles_match_pallas(P, tile):
    """count_tiles over a list of (tile x tile) tiles, in the list's order
    and with repeats, equals the Pallas kernel's counts at that tile; one
    operand and two (the streaming engine's row tile and window)."""
    n = 768 if tile == 384 else N
    jplanes, thr, planes, t = _state(P, n=n)
    nt = n // tile
    grid = _pallas(jplanes[:, :nt * tile], thr[:nt * tile], tile, tile)
    coords = np.array([(r, c) for r in range(nt) for c in range(nt)])[::-1]
    coords = np.concatenate([coords, coords[:2]])
    got = pp.count_tiles(planes, t, planes, t, coords, tile, D)
    assert grid.sum() > 0
    np.testing.assert_array_equal(got.numpy(),
                                  grid[coords[:, 0], coords[:, 1]])
    # row tile 1 against a window of column tiles 1.. (two operands)
    pi, ti = planes[:, tile:2 * tile].contiguous(), t[tile:2 * tile]
    pj, tj = planes[:, tile:].contiguous(), t[tile:]
    win = [(0, j) for j in range(nt - 1)]
    np.testing.assert_array_equal(
        pp.count_tiles(pi, ti, pj, tj, pp.TileList(win, "cpu"), tile,
                       D).numpy(), grid[1, 1:])


@pytest.mark.parametrize("P", [1, 3, 6])
def test_count_any_split_same_counts(P):
    """The plain version swept at any sub-block split of a tile (the whole
    tile, the JAX engine's blocks, kernel COUNT's 256 x 256 items, thin and
    flat strips) gives the same per-tile counts, and so does sweep_counts
    at the split's blocks, summed to the tile."""
    _, _, planes, t = _state(P)
    tile = 512
    coords = [(r, c) for r in range(2) for c in range(2)]
    want = pp.count_tiles_plain(planes, t, planes, t, coords, tile, D)
    assert int(want.sum()) > 0
    splits = {pp.engine_blocks(P, tile, "cuda"), (256, 256), (128, 128),
              (512, 64), (32, 512), (256, 128)}
    for blocks in splits:
        np.testing.assert_array_equal(
            pp.count_tiles_plain(planes, t, planes, t, coords, tile, D,
                                 blocks).numpy(), want.numpy())
        bi, bj = blocks
        sub = pp.sweep_counts(planes, t, D, block=bi, block_j=bj)
        summed = sub.reshape(2, tile // bi, 2, tile // bj).sum(dim=(1, 3))
        np.testing.assert_array_equal(summed.reshape(-1).numpy(),
                                      want.numpy())


def test_count_tiles_checks_the_list():
    """A TileList is checked once; count_tiles refuses tiles outside the
    planes and blocks that do not divide the tile; a CPU list stays on the
    host; a list and its TileList give the same counts."""
    _, _, planes, t = _state(3, n=512)
    with pytest.raises(ValueError):
        pp.TileList([(0, -1)], "cpu")
    tl = pp.TileList([(1, 0), (0, 1)], "cpu")
    assert len(tl) == 2 and tl.ends == (2, 2) and tl.dev is None
    np.testing.assert_array_equal(
        pp.count_tiles(planes, t, planes, t, tl, 256, D).numpy(),
        pp.count_tiles(planes, t, planes, t, tl.host, 256, D).numpy())
    with pytest.raises(ValueError):
        pp.count_tiles(planes, t, planes, t, [(2, 0)], 256, D)
    with pytest.raises(ValueError):
        pp.count_tiles(planes, t, planes[:, :256].contiguous(), t[:256],
                       [(0, 1)], 256, D)
    with pytest.raises(ValueError):
        pp.count_tiles_plain(planes, t, planes, t, [(0, 0)], 256, D,
                             (96, 128))
    assert len(pp.count_tiles(planes, t, planes, t, [], 256, D)) == 0


@pytest.mark.parametrize("slots", [1, 3])
def test_mesh_tile_lists(slots):
    """MeshSweepOps.tile_lists splits a list into the per-slot blocks (one
    TileList a slot, None past the end) and sweep_counts over them returns
    count_tiles' counts in list order."""
    _, _, planes, t = _state(3, n=512)
    ops = MeshSweepOps(Mesh([torch.device("cpu")] * slots))
    coords = np.array([(r, c) for r in range(2) for c in range(2)])
    lists = ops.tile_lists(coords)
    assert len(lists) == slots
    assert sum(len(x) for x in lists if x is not None) == len(coords)
    want = pp.count_tiles(planes, t, planes, t, coords, 256, D)
    got = ops.sweep_counts(*ops.replicate(planes, t), lists, 256, D)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want.numpy())
    lists1 = ops.tile_lists(coords[:1])
    assert lists1[0] is not None and all(x is None for x in lists1[1:])
