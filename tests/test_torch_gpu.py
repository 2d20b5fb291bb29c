"""Kernels of the port against their plain PyTorch versions on the GPU.

Marked ``gpu``: each test skips (with its reason) where CUDA is not
available, so these count as no pass on a CPU-only host. On a machine with
an NVIDIA GPU (no JAX needed) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Equality is exact: the kernels compute integer results exactly and the
float32 sweep combine in the plain version's order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _state(dev, N=512, d=200, max_abs=3000, seed=0):
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    rng = np.random.default_rng(seed)
    V = rng.integers(-max_abs, max_abs + 1, size=(N, d)).astype(np.int32)
    V[1] = V[0]
    V[20:40] = np.clip(V[19] + rng.integers(-3, 4, size=(20, d)),
                       -max_abs, max_abs)
    L = pm.pick_limbs(max_abs)
    planes = torch.zeros((pm.num_planes(L), N, pw.pad_dim(d)),
                         dtype=torch.int8, device=dev)
    pw.planes_update(planes, pw.decompose_limbs(
        torch.from_numpy(V).to(dev), L), 0)
    ns = np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64)) / d
    thr = torch.from_numpy(ns.astype(np.float32)).to(dev)
    return V, L, planes, thr


def test_projection_kernel_matches_plain(cuda):
    from metagenome_vector_sketches_tpu_torch.ops import projection as pj
    rng = np.random.default_rng(1)
    sizes = np.array([0, 1, 31, 32, 33, 1000, 7])
    flat = rng.integers(0, 2**64, size=int(sizes.sum()), dtype=np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    for d in (64, 200, 2048):
        got = pj.project_batch(flat.view(np.int64), offsets, d, cuda)
        h = torch.from_numpy(flat.view(np.int64)).to(cuda)
        o = torch.from_numpy(offsets.astype(np.int64)).to(cuda)
        assert torch.equal(got, pj.project_batch_plain(h, o, d))


@pytest.mark.parametrize("max_abs", [3000, 30000])
def test_sweep_kernel_matches_plain(cuda, max_abs):
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    _, _, planes, thr = _state(cuda, max_abs=max_abs)
    for kw in (dict(block=128), dict(block=256, block_j=128),
               dict(row_t0=1, row_t1=3, block=128)):
        assert torch.equal(pp.sweep_counts(planes, thr, 200, **kw),
                           pp.sweep_counts_plain(planes, thr, 200, **kw))
    coords = np.array([(r, c) for r in range(4) for c in range(r, 4)])
    got = pw.sweep_extract(planes, thr, planes, thr, coords, 128, 1 << 16,
                           True, 200)
    want = pw.sweep_extract_plain(planes, thr, planes, thr, coords, 128,
                                  1 << 16, True, 200)
    n = int(want[2].item())
    assert n > 0 and torch.equal(got[1], want[1]) and torch.equal(got[2],
                                                                  want[2])
    key = lambda rc: sorted(map(tuple, rc[:n].tolist()))  # noqa: E731
    assert key(got[0]) == key(want[0])


def test_partials_kernel_matches_plain(cuda):
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    for max_abs in (100, 3000, 30000, 2000000):
        _, L, planes, _ = _state(cuda, max_abs=max_abs)
        rc = torch.randint(0, 512, (3000, 2), dtype=torch.int32, device=cuda)
        assert torch.equal(pw.pair_partials(planes, rc, L),
                           pw.pair_partials_plain(planes, rc, L))


@pytest.mark.parametrize("max_abs,int16", [(3000, False), (30000, True)])
def test_engine_cuda_shard_equals_cpu_shard(cuda, tmp_path, max_abs, int16):
    """P = 3 (int32) and P = 6 (int16) databases, N not a multiple of the
    tile, d not a multiple of 64: the GPU shard equals the CPU shard."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch.host import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    V, _, _, _ = _state("cpu", N=700, d=200, max_abs=max_abs)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(700)],
                        V, 200, use_int16=int16)
    for dev in ("cpu", "cuda"):
        for s in range(2):
            mc.compute_pairwise_shard(db.path, str(tmp_path / dev), 2, s,
                                      tile_rows=128, verbose=False,
                                      device=dev)
    for s in range(2):
        for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
            assert filecmp.cmp(tmp_path / "cpu" / f"shard_{s}" / f,
                               tmp_path / "cuda" / f"shard_{s}" / f,
                               shallow=False)
