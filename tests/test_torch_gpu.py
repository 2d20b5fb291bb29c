"""Kernels of the port against their plain PyTorch versions on the GPU.

Marked ``gpu``: each test skips (with its reason) where CUDA is not
available, so these count as no pass on a CPU-only host. On a machine with
an NVIDIA GPU (no JAX needed) run them with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Equality is exact: the kernels compute integer results exactly and the
float32 sweep combine in the plain version's order.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from keep_cases import CASES as KEEP_CASES  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import projection as pj  # noqa: E402

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


def _project_both(dev, sizes, d, seed=1, flat=None):
    """Kernel P (offsets from the host and from the device) and the plain
    version on the same CSR batch."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, dtype=np.int64)
    if flat is None:
        flat = rng.integers(0, 2**64, size=int(sizes.sum()), dtype=np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    h = torch.from_numpy(flat.view(np.int64)).to(dev)
    o = torch.from_numpy(offsets).to(dev)
    want = pj.project_batch_plain(h, o, d)
    for off in (offsets, o):
        # leave garbage in the block the caching allocator hands out next:
        # every output row must be written (split sets' rows zeroed first)
        torch.full(want.shape, -7, dtype=torch.int32, device=dev)
        assert torch.equal(pj.project_batch(h, off, d, dev), want)


def test_projection_kernel_matches_plain(cuda):
    for d in (64, 200, 2048):
        _project_both(cuda, [0, 1, 31, 32, 33, 1000, 7], d)


def test_project_batch_cpu_device_takes_cuda_tensors(cuda):
    """device="cpu" runs the plain version on CUDA inputs moved over."""
    sizes = np.array([3, 0, 700])
    flat = np.random.default_rng(4).integers(0, 2**64, size=int(sizes.sum()),
                                             dtype=np.uint64)
    h = torch.from_numpy(flat.view(np.int64))
    o = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]))
    got = pj.project_batch(h.to(cuda), o.to(cuda), 256, "cpu")
    assert got.device.type == "cpu"
    assert torch.equal(got, pj.project_batch_plain(h, o, 256))


# around the Harley-Seal group (16 words), the lane counter's capacity
# (MAX_CHUNK = 4,095 = 2^12 - 1 words, reached by an item of that size)
# and the work item (CHUNK hashes)
@pytest.mark.parametrize("sizes,chunk", [
    ([0], pj.CHUNK), ([1], pj.CHUNK), ([15, 16, 17], pj.CHUNK),
    ([255, 256, 257], pj.CHUNK),
    ([4095], 4095), ([4096], 4095), ([4097], 4095),
    ([pj.CHUNK], pj.CHUNK), ([pj.CHUNK + 1], pj.CHUNK),
    ([3 * pj.CHUNK + 7, 2, 0, pj.CHUNK + 1], pj.CHUNK),
    ([1 << 20], pj.CHUNK)])
def test_projection_kernel_set_sizes(cuda, monkeypatch, sizes, chunk):
    monkeypatch.setattr(pj, "CHUNK", chunk)
    _project_both(cuda, sizes, 2048)


def test_projection_kernel_identical_hashes_fill_the_counter(cuda,
                                                            monkeypatch):
    """Every word equal: each lane count reaches the item's full size."""
    monkeypatch.setattr(pj, "CHUNK", pj.MAX_CHUNK)
    sizes = [4095, 4096, 8191, 12292]
    flat = np.full(sum(sizes), 0xDEADBEEF12345678, dtype=np.uint64)
    _project_both(cuda, sizes, 256, flat=flat)


def test_projection_kernel_toy_largest_set(cuda):
    import pathlib
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)
    toy = pathlib.Path(__file__).parent / "fixtures" / "ref_toy"
    named = parse_hashes_file(str(toy / "all_hashes_toy.txt"))
    sets = sorted((h for _, h in named), key=len)
    assert len(sets[-1]) == 80772
    flat = np.concatenate([sets[-1], sets[0], sets[len(sets) // 2]])
    _project_both(cuda, [len(sets[-1]), len(sets[0]),
                         len(sets[len(sets) // 2])], 2048,
                  flat=flat.astype(np.uint64))


@pytest.mark.parametrize("d", [1, 63, 64, 100, 256, 2048, 4096])
def test_projection_kernel_dimensions(cuda, d):
    _project_both(cuda, [0, 1, 16, 17, 300, 5000, 3], d, seed=d)


def test_projection_kernel_fewer_sets_than_sms(cuda):
    _project_both(cuda, np.arange(1, 60) * 101, 2048)


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


def _survivors(rc, n):
    return set(map(tuple, rc[:n].tolist()))


@pytest.mark.parametrize("max_abs", [100, 3000, 30000, 2000000])
@pytest.mark.parametrize("d", [64, 192, 2048])
def test_sweep_core_matches_plain(cuda, d, max_abs):
    """Kernel S's TMA/wgmma core at d_pad = 64, 192 (an odd number of
    64-byte K steps) and 2048, P = 1, 3, 6, 10: COUNT on 128 x 128, 128 x
    256 and 256 x 128 tiles, APPEND on one 128-row tile, on the 128-tile
    triangle and on 128 x 256 tiles — all equal to the plain version."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    _, L, planes, thr = _state(cuda, N=512, d=d, max_abs=max_abs, seed=d)
    assert planes.shape[0] == L * (L + 1) // 2 and planes.shape[2] == d
    for kw in (dict(block=128), dict(block=128, block_j=256),
               dict(block=256, block_j=128)):
        assert torch.equal(pp.sweep_counts(planes, thr, d, **kw),
                           pp.sweep_counts_plain(planes, thr, d, **kw))
    cap = 1 << 17
    for coords in ([(0, 0)], [(r, c) for r in range(4) for c in range(r, 4)]):
        got = pw.sweep_extract(planes, thr, planes, thr, coords, 128, cap,
                               True, d)
        want = pw.sweep_extract_plain(planes, thr, planes, thr, coords, 128,
                                      cap, True, d)
        n = int(want[2].item())
        assert n > 0 and torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[2])
        assert _survivors(got[0], n) == _survivors(want[0], n)
    # 128 x 256 tiles: the survivors of their 128 x 128 halves
    wide = np.array([(r, c) for r in range(4) for c in range(2)])
    counts, rc, total = pw.launch_sweep(planes, thr, planes, thr, wide, 128,
                                        256, d, mask_self=True, cap=cap)
    halves = [(r, 2 * c + h) for r, c in wide.tolist() for h in range(2)]
    want = pw.sweep_extract_plain(planes, thr, planes, thr, halves, 128, cap,
                                  True, d)
    n = int(want[2].item())
    assert int(total.item()) == n
    assert torch.equal(counts, want[1].view(-1, 2).sum(1).to(torch.int32))
    assert _survivors(rc, n) == _survivors(want[0], n)


def test_partials_kernel_matches_plain(cuda):
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    for max_abs in (100, 3000, 30000, 2000000):
        _, L, planes, _ = _state(cuda, max_abs=max_abs)
        rc = torch.randint(0, 512, (3000, 2), dtype=torch.int32, device=cuda)
        flag = pw.range_flag(cuda)
        assert torch.equal(pw.pair_partials(planes, rc, L, flag=flag),
                           pw.pair_partials_plain(planes, rc, L))
        pw.check_range_flag(flag)


@pytest.mark.parametrize("d_pad", [16, 64, 2048])
@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
def test_partials_kernel_limbs_and_widths(cuda, L, d_pad):
    """L = 1..5 limbs at d_pad 16, 64, 2048: one pair, a count that is not a
    multiple of a CTA's 16 candidates, repeated rows, two operands."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    g = torch.Generator(device=cuda).manual_seed(L * d_pad)
    P = pm.num_planes(L)
    x = torch.randint(-128, 128, (P, 40, d_pad), generator=g, device=cuda,
                      dtype=torch.int8)
    y = torch.randint(-128, 128, (P, 70, d_pad), generator=g, device=cuda,
                      dtype=torch.int8)
    flag = pw.range_flag(cuda)
    for n in (1, 77, 5000):
        rc = torch.stack([torch.randint(0, 40, (n,), generator=g, device=cuda),
                          torch.randint(0, 40, (n,), generator=g,
                                        device=cuda)], 1).to(torch.int32)
        rc[n // 2:] = rc[0]                             # repeated rows
        rc = rc.contiguous()
        assert torch.equal(pw.pair_partials(x, rc, L, flag=flag),
                           pw.pair_partials_plain(x, rc, L))
        rc2 = rc.clone()
        rc2[:, 1] = (rc2[:, 1] * 7) % 70
        assert torch.equal(pw.pair_partials(x, rc2, L, y, flag),
                           pw.pair_partials_plain(x, rc2, L, y))
    pw.check_range_flag(flag)


def test_partials_kernel_range_flag(cuda):
    """Out-of-range candidates are counted, not computed: ValueError where
    the flag is read; the next launch in the process still works."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    _, L, planes, _ = _state(cuda, max_abs=3000)
    good = torch.tensor([[0, 1], [5, 7]], dtype=torch.int32, device=cuda)
    for bad in ([512, 0], [0, -1], [-3, 2], [0, 512]):
        flag = pw.range_flag(cuda)
        rc = torch.cat([good, torch.tensor([bad], dtype=torch.int32,
                                           device=cuda)]).contiguous()
        out = pw.pair_partials(planes, rc, L, flag=flag)
        with pytest.raises(ValueError, match="1 candidate pair"):
            pw.check_range_flag(flag)
        assert torch.equal(out[:2], pw.pair_partials_plain(planes, good, L))
    with pytest.raises(ValueError, match="flag"):
        pw.pair_partials(planes, good, L)
    flag = pw.range_flag(cuda)
    assert torch.equal(pw.pair_partials(planes, good, L, flag=flag),
                       pw.pair_partials_plain(planes, good, L))
    pw.check_range_flag(flag)
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", KEEP_CASES)
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_keep_kernel_matches_plain(cuda, dtype, L, case):
    """Kernel X's retention epilogue against its plain version and the host
    path it replaced, on the CPU tests' random and adversarial cases
    (tests/keep_cases.py): the threshold hit exactly and one ulp off,
    negative dots between truncation and floor, int16 quotients that round
    onto the threshold, twins on tile edges, a shard that starts inside a
    tile, padding columns, two operands with their own first rows."""
    from keep_cases import host_path, keep, make_case
    c = make_case(case, dtype == "int16", L, seed=L)
    cap = 2 * len(c["rc"])
    got = keep(c, cap, device=cuda)
    assert got == keep(c, cap)
    assert got[0] == host_path(c)[0]
    for a, b, dot, kept in c["adversarial"]:
        assert ((a, b, dot) in got[0]) == kept


@pytest.mark.parametrize("int16", [False, True])
def test_keep_kernel_million_candidates(cuda, int16):
    """10^6 random candidates and the planted near-twins of a 8,192-row
    d = 2048 db (L = 3, int16-sized components), twins on tile 256 of a
    shard [1000, 7000) of 8,000 rows: the kernel's kept pairs and counters
    equal the plain version's on the card."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    V, L, planes, _ = _state(cuda, N=8192, d=2048, max_abs=30000, seed=4)
    g = torch.Generator(device=cuda).manual_seed(5)
    rnd = torch.randint(0, 8192, (10**6, 2), generator=g, device=cuda)
    near = torch.cartesian_prod(torch.arange(19, 40, device=cuda),
                                torch.arange(19, 40, device=cuda))
    rc = torch.cat([rnd, near]).to(torch.int32).contiguous()
    dots = V[100:164].astype(np.float64) @ V[200:264].astype(np.float64).T
    scale = float(np.abs(dots).mean()) / 2048
    ns = torch.rand(8192, dtype=torch.float64, generator=g,
                    device=cuda) * 20 * scale
    keep = pw.Retention(ns, 2048, int16, 1000, 7000, 8000)
    twins = (256, 1000 // 256, (7000 - 1) // 256 + 1)
    out, counters = pw.pair_keep(planes, rc, L, keep, 1 << 20, twins=twins)
    want_out, want = pw.pair_keep_plain(planes, rc, L, keep, 1 << 20,
                                        twins=twins)
    assert torch.equal(counters, want)
    n = int(want[0])
    assert 100 < n < 1 << 20
    assert _survivors(out, n) == _survivors(want_out, n)


def test_keep_kernel_capacity_rerun_and_range_flag(cuda):
    """Kept counts past a short buffer, exactly (read_kept refuses it; the
    mesh's pair_keep reruns each slot at its exact count, here on two slots
    of one card with a first buffer of one pair); out-of-range candidates
    are counted and write nothing; refused operands raise."""
    from keep_cases import host_path, make_case, retention
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.parallel.engine import (
        MeshSweepOps)
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    c = make_case("tile_edges", False, 2)
    want, _, emitted = host_path(c)
    planes, rc = c["planes"].to(cuda), c["rc"].to(cuda)
    keep = retention(c, cuda)
    out, counters = pw.pair_keep(planes, rc, 2, keep, 5, twins=c["twins"])
    counts = counters.cpu().numpy()
    assert counts.tolist() == [len(want), emitted, 0] and len(want) > 5
    with pytest.raises(RuntimeError, match="buffer of 5"):
        pw.read_kept(out, counts)
    ops = MeshSweepOps(Mesh([cuda, cuda]))
    half = len(rc) // 2
    swept = [(rc[:half].contiguous(), half),
             (rc[half:].contiguous(), len(rc) - half)]
    kept, em, nbytes = ops.pair_keep((planes,) * 2, swept, 2, [keep] * 2, 1,
                                     twins=c["twins"])
    got = set()
    for r, cc, dots in kept:
        got |= set(zip(r.tolist(), cc.tolist(), dots.tolist()))
    assert got == want and em == emitted
    assert nbytes == len(want) * pw.KEPT_BYTES + 4 * pw.COUNTER_BYTES
    bad = torch.cat([rc, torch.tensor([[320, 0], [0, -1], [-3, 2]],
                                      dtype=torch.int32, device=cuda)])
    out, counters = pw.pair_keep(planes, bad.contiguous(), 2, keep,
                                 len(want), twins=c["twins"])
    assert counters.tolist() == [len(want), emitted, 3]
    with pytest.raises(ValueError, match="3 candidate pair"):
        pw.read_kept(out, counters.cpu().numpy())
    with pytest.raises(ValueError, match="float64"):
        pw.pair_keep(planes, rc, 2, pw.Retention(keep.ns.float(), 200, False,
                                                 0, 10, 300), 10)
    with pytest.raises(ValueError, match="tile"):
        pw.pair_keep(planes, rc, 2, keep, 10, twins=(0, 0, 1))
    out, counters = pw.pair_keep(planes, rc, 2, keep, len(want),
                                 twins=c["twins"])
    (r, cc, dots), _ = pw.read_kept(out, counters.cpu().numpy())
    assert set(zip(r.tolist(), cc.tolist(), dots.tolist())) == want
    torch.cuda.synchronize()


@pytest.mark.parametrize("max_abs,int16", [(3000, False), (30000, True)])
def test_engine_cuda_shard_equals_cpu_shard(cuda, tmp_path, max_abs, int16):
    """P = 3 (int32) and P = 6 (int16) databases, N not a multiple of the
    tile, d not a multiple of 64: the GPU shard equals the CPU shard."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
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


def _scan_state(dev, N, d, max_abs, B, seed):
    """Padded query planes (B rows) and one db chunk of N valid rows."""
    from metagenome_vector_sketches_tpu_torch.ann import int_index as ii
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    rng = np.random.default_rng(seed)
    V = rng.integers(-max_abs, max_abs + 1, size=(N, d)).astype(np.int32)
    V[3] = 0
    Q = rng.integers(-max_abs, max_abs + 1, size=(B, d)).astype(np.int32)
    Q[0] = V[5]
    L = pm.pick_limbs(max_abs)
    qp = ii.query_planes(Q, L, dev)
    db = ii.query_planes(V, L, dev)
    inv = torch.from_numpy(rng.random(db.shape[1]).astype(np.float32)).to(dev)
    return L, qp, db, inv


@pytest.mark.parametrize("B", [1, 37, 256])
@pytest.mark.parametrize("d,max_abs", [(200, 3000), (2048, 600),
                                       (2048, 30000)])
def test_scan_kernel_matches_plain(cuda, B, d, max_abs):
    """Kernel S SCORE against its plain version, bit for bit (P = 3, 6)."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    _, qp, db, inv = _scan_state(cuda, 1000, d, max_abs, B, seed=B + d)
    assert db.shape[1] == 1024 and qp.shape[0] in (3, 6)
    got = pw.scan_scores(qp, db, inv, 1000)
    want = pw.scan_scores_plain(qp, db, inv, 1000)
    assert got.shape == (qp.shape[1], 1024)
    assert torch.equal(got, want)
    assert bool(torch.isinf(got[:, 1000:]).all())


@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("d,max_abs", [(64, 100), (192, 2000000)])
def test_scan_core_matches_plain(cuda, B, d, max_abs):
    """Kernel S SCORE at d_pad = 64 and 192, P = 1 and 10, on a chunk of
    640 rows (an odd number of 128-row blocks) with 555 valid."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    _, qp, db, inv = _scan_state(cuda, 640, d, max_abs, B, seed=B + d)
    assert qp.shape[0] in (1, 10) and db.shape[1] == 640
    got = pw.scan_scores(qp, db, inv, 555)
    assert torch.equal(got, pw.scan_scores_plain(qp, db, inv, 555))
    assert bool(torch.isinf(got[:, 555:]).all())
    assert not bool(torch.isinf(got[:, :555]).any())


def test_two_operand_partials_kernel_matches_plain(cuda):
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    for max_abs in (100, 3000, 30000, 2000000):
        L, qp, db, _ = _scan_state(cuda, 500, 200, max_abs, 37, seed=7)
        rc = torch.stack([torch.randint(0, 37, (3000,), device=cuda),
                          torch.randint(0, 500, (3000,), device=cuda)],
                         1).to(torch.int32).contiguous()
        flag = pw.range_flag(cuda)
        got = pw.pair_partials(qp, rc, L, db, flag)
        pw.check_range_flag(flag)
        assert torch.equal(got, pw.pair_partials_plain(qp, rc, L, db))
        assert got.shape == (3000, pm.num_planes(L))


@pytest.mark.parametrize("n,d,mag,chunk", [(1000, 200, 3000, 300),
                                           (700, 2048, 30000, 700)])
def test_int_index_cuda_equals_cpu(cuda, n, d, mag, chunk):
    from metagenome_vector_sketches_tpu_torch.ann.int_index import (
        IntExactIndex)
    rng = np.random.default_rng(n)
    V = rng.integers(-mag, mag + 1, size=(n, d)).astype(np.int32)
    V[9] = V[4]
    Q = rng.integers(-mag, mag + 1, size=(37, d)).astype(np.int32)
    Q[0] = V[4]
    results = [IntExactIndex(V, chunk_rows=chunk, device=dev).search(Q, 60)
               for dev in ("cpu", cuda)]
    (Dc, Ic), (Dg, Ig) = results
    assert np.array_equal(Ic, Ig) and np.array_equal(Dc, Dg)
    assert Ig[0, :2].tolist() == [4, 9]


@pytest.mark.parametrize("precision", ["f32", "bf16_rescore"])
def test_flat_index_cuda_matches_cpu(cuda, precision):
    from metagenome_vector_sketches_tpu_torch.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    rng = np.random.default_rng(3)
    V = normalize_l2(rng.normal(size=(3000, 256)).astype(np.float32))
    Q = normalize_l2(V[:20] + 0.05 * rng.normal(size=(20, 256))
                     .astype(np.float32))
    (Dc, Ic), (Dg, Ig) = [
        FlatIPIndex(V, chunk_rows=1000, precision=precision,
                    device=dev).search(Q, 30) for dev in ("cpu", cuda)]
    np.testing.assert_allclose(Dg, Dc, rtol=0, atol=1e-5)
    assert (Ig[:, 0] == np.arange(20)).all()
    for b in range(20):                 # equal outside near-ties
        diff = np.nonzero(Ig[b] != Ic[b])[0]
        assert all(abs(Dc[b, r] - Dc[b, r - 1]) < 1e-5
                   or abs(Dc[b, min(r + 1, 29)] - Dc[b, r]) < 1e-5
                   for r in diff)


def _select_scores(dev, B, R, valid, seed, all_inf_row=False,
                   equal_row=False):
    """(B, R) float32 scores with large exact-tie classes (a few values,
    +0.0 and -0.0 among them) and runs of the row maximum straddling
    128-lane blocks; -inf past valid (the SCORE epilogue's mask);
    ``equal_row``: the last row one finite score throughout."""
    rng = np.random.default_rng(seed)
    S = (rng.integers(-6, 7, size=(B, R)) / 4).astype(np.float32)
    S[:, 1::9] = -0.0
    for a, b in ((120, 136), (255, 258), (1023, 1026)):
        S[:, a:min(b, R)] = 2.0
    S[:, valid:] = -np.inf
    if all_inf_row:
        S[0] = -np.inf
    if equal_row:
        S[-1] = 0.5
    return torch.from_numpy(S).to(dev)


def _select_pool(dev, B, W0, seed):
    """A running pool of W0 keys per row, sorted best first, as the
    previous chunk's merge leaves it (scores that tie the chunk's)."""
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    rng = np.random.default_rng(seed)
    s = torch.from_numpy((rng.integers(-6, 9, size=(B, 3 * W0 + 1)) / 4)
                         .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 5000, size=(B, 3 * W0 + 1)))
    return sel.select_keys_plain(sel.rank_keys(s, idx), W0)[0] \
        .contiguous().to(dev)


@pytest.fixture
def no_plain_select(monkeypatch):
    """Kernel K's plain versions raise: a CUDA input must never reach
    them. Yields the real ones, for the comparisons."""
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    real = (sel.select_chunk_plain, sel.select_keys_plain)

    def refusing(plain):
        def call(*a, **kw):
            assert not any(isinstance(x, torch.Tensor) and x.is_cuda
                           for x in a), "a CUDA tensor reached " \
                f"{plain.__name__}"
            return plain(*a, **kw)
        return call

    monkeypatch.setattr(sel, "select_chunk_plain", refusing(real[0]))
    monkeypatch.setattr(sel, "select_keys_plain", refusing(real[1]))
    return real


# kernel K's chunk cases: kc label -> (R, kc)
_SELECT_KC = {"1": (2048, 1), "nb": (2048, 16), "nb+1": (2048, 17),
              "R": (2048, 2048), "2500": (5000, 2500),
              "114 of 40000": (40000, 114), "5000 of 20000": (20000, 5000),
              "R of 20000": (20000, 20000)}


@pytest.mark.parametrize("B", [1, 256])
@pytest.mark.parametrize("kc", list(_SELECT_KC))
@pytest.mark.parametrize("valid,W0", [(2048, 0), (1500, "pool"),
                                      (5, "pool"), (2048, "pool")])
def test_select_chunk_kernel_matches_plain(cuda, no_plain_select, B, kc,
                                           valid, W0):
    """Kernel K's chunk entry bit-equal to its plain version (keys, lanes,
    merged keys, positions) in each of its regimes: a 2048-lane chunk (nb =
    16 blocks) at kc 1 (two-stage), nb, nb + 1 and R (one CTA a row); kc =
    2500 of 5000 and 5000 of 20000 (the multi-CTA radix select and the
    grid-wide sort); 114 of 40000 (two-stage over 5 tiles a row, the last
    CTA's row stage); R of 20000 (the full sort). valid < R, a valid count
    below kc (no-row lanes in the chunk top), all -inf rows and, on the
    wider chunks, a row of one finite score (the row stage's survivor
    overflow); W0 = 0 and the pool."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    chunk_plain, _ = no_plain_select
    R, kc = _SELECT_KC[kc]
    pool = max(kc, 7)
    w0 = pool if W0 == "pool" else 0
    scores = _select_scores(cuda, B, R, min(valid, R), seed=B + kc,
                            all_inf_row=valid == 2048 and W0 == "pool",
                            equal_row=R > 5000)
    best = _select_pool(cuda, B, w0, seed=kc) if w0 else \
        torch.empty((B, 0), dtype=torch.int64, device=cuda)
    _build.reset_launch_counts()
    got = sel.select_chunk(scores, 7000, valid, 90000, kc, best, pool)
    assert _build.launch_counts()["select"] == 1
    want = chunk_plain(scores, 7000, valid, 90000, kc, best, pool)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("keys", "lanes", "merged", "pos")):
        assert g.device == scores.device and torch.equal(g, w), what


def test_select_chunk_kernel_strided_rows(cuda, no_plain_select):
    """Rows of a wider tensor (the int8 engine's scores[:B] of a padded
    batch, a column slice): the kernel reads the row stride."""
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    chunk_plain, _ = no_plain_select
    full = _select_scores(cuda, 300, 2200, 2200, seed=4)
    best = _select_pool(cuda, 256, 114, seed=5)
    # the last slice is not 16-byte aligned: scalar loads
    for scores in (full[:256], full[:256, 100:2148], full[:256, 101:2149]):
        got = sel.select_chunk(scores, 0, 2000, 2 ** 32 - 1, 114, best, 114)
        want = chunk_plain(scores, 0, 2000, 2 ** 32 - 1, 114, best, 114)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("B,W,k", [(1, 1, 5), (256, 228, 114),
                                   (37, 7000, 50), (3, 3000, 3000),
                                   (2, 9000, 2100), (2, 9000, 9000),
                                   (5, 40000, 700)])
def test_select_keys_kernel_matches_plain(cuda, no_plain_select, B, W, k):
    """Kernel K's key entry bit-equal to its plain version, with duplicate
    keys (their positions then decide)."""
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    _, keys_plain = no_plain_select
    rng = np.random.default_rng(W)
    s = torch.from_numpy((rng.integers(-4, 5, size=(B, W)) / 2)
                         .astype(np.float32))
    keys = sel.rank_keys(s, torch.from_numpy(
        rng.integers(0, 40, size=(B, W)))).to(cuda)
    got = sel.select_keys(keys, k)
    want = keys_plain(keys, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_select_kernel_on_two_streams_of_one_device(cuda, no_plain_select):
    """Two launches of kernel K in flight at once on two streams of one
    card (as the mesh slots launch it), each with its own per-row arrival
    counters and radix state: both results bit-equal to the plain
    version, repeated so that the launches overlap."""
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    chunk_plain, _ = no_plain_select
    cases = []
    for seed, (R, kc) in enumerate(((40000, 114), (20000, 5000),
                                    (40000, 50), (9000, 9000))):
        scores = _select_scores(cuda, 256, R, R - 33, seed=seed,
                                equal_row=True)
        best = _select_pool(cuda, 256, kc, seed=seed + 9)
        cases.append((scores, 11, R - 33, 2 ** 32 - 1, kc, best, kc))
    wants = [chunk_plain(*c) for c in cases]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    gots = []
    for _ in range(3):
        for i, c in enumerate(cases):
            with torch.cuda.stream(streams[i % 2]):
                gots.append((i, sel.select_chunk(*c)))
    torch.cuda.synchronize()
    for i, got in gots:
        for g, w, what in zip(got, wants[i], ("keys", "lanes", "merged",
                                              "pos")):
            assert torch.equal(g, w), (i, what)


def test_pairwise_comp_any_tile_on_cuda(cuda, tmp_path):
    """--tile 32 rounds up to kernel S's block on CUDA and writes the same
    shard bytes as --tile 2048."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch.cli import pairwise_comp
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    V, _, _, _ = _state("cpu", N=700, d=200, max_abs=3000)
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(700)],
                        V, 200)
    for tile in ("32", "2048"):
        assert pairwise_comp.main(
            ["--db", db.path, "--max_memory_gb", "1", "--num_threads", "1",
             "--output_folder", str(tmp_path / tile), "--num_shards", "1",
             "--shard_idx", "0", "--tile", tile]) == 0
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert filecmp.cmp(tmp_path / "32" / "shard_0" / f,
                           tmp_path / "2048" / "shard_0" / f, shallow=False)


def _padded_incidence(dev, n, u, density, seed):
    """(pad_rows(n), u rounded up to 64) int8 0/1 chunk, zero padded."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    rng = np.random.default_rng(seed)
    A = np.zeros((pw.pad_rows(n, "cuda"), pw.pad_dim(u)), dtype=np.int8)
    A[:n, :u] = rng.random((n, u)) < density
    return torch.from_numpy(A).to(dev)


def test_minhash_intersections_cuda_equal_cpu(cuda):
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    rng = np.random.default_rng(61)
    sets_ = [rng.choice(20000, size=rng.integers(0, 900), replace=False)
             .astype(np.uint64) for _ in range(37)]
    for rows in (7, 1 << 14):
        assert np.array_equal(
            mh.pairwise_intersections(sets_, rows_per_block=rows, device=cuda),
            mh.pairwise_intersections(sets_, rows_per_block=rows,
                                      device="cpu"))


@pytest.mark.parametrize("n,u,b,e", [
    (1, 1, 0, 1), (130, 100, 0, 130), (1000, 16384, 128, 300),
    (700, 64, 500, 700), (384, 1000, 5, 6), (384, 64, 0, 384)])
def test_gram_rows_kernel_matches_plain(cuda, n, u, b, e):
    """Kernel G (rows b..e-1 against every row, ragged
    n, u and row ranges, zero padded) against the plain float64 rows; the
    pad rows of its output are 0."""
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    A = _padded_incidence(cuda, n, u, 0.05, 4)
    got = mh.gram_rows(A, b, e)
    assert got.shape == ((e - b + 127) // 128 * 128, A.shape[0])
    assert torch.equal(got[:e - b], mh.gram_rows_plain(A, b, e))
    assert not bool(got[e - b:].any())


def _postings(dev, n, n_post, most, seed):
    """Random light postings: n_post ascending runs of 2..most distinct set
    ids below n."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, most + 1, size=n_post)
    sets = np.concatenate([np.sort(rng.choice(n, size=k, replace=False))
                           for k in lens]).astype(np.int32)
    off = np.zeros(n_post + 1, dtype=np.int64)
    off[1:] = np.cumsum(lens)
    return torch.from_numpy(sets).to(dev), torch.from_numpy(off).to(dev)


@pytest.mark.parametrize("n,n_post,most,b,e", [
    (300, 2000, 40, 0, 300), (5000, 20000, 255, 1000, 1700),
    (1000, 5000, 2, 990, 1000), (2048, 3000, 127, 128, 1152)])
def test_cooc_kernel_matches_plain(cuda, n, n_post, most, b, e):
    """Kernel C over random light postings (on top of a nonzero
    accumulator) against the plain version: the same counts and the same
    number of increments."""
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    sets, off = _postings(cuda, n, n_post, most, seed=n)
    base = torch.randint(0, 5, (e - b + 3, n + 8), dtype=torch.int32,
                         device=cuda)
    got, want = base.clone(), base.clone()
    cg = torch.zeros(1, dtype=torch.int64, device=cuda)
    cw = torch.zeros_like(cg)
    mh.cooc_accumulate(got, sets, off, b, e, cg)
    mh.cooc_accumulate_plain(want, sets, off, b, e, cw)
    assert torch.equal(got, want) and torch.equal(cg, cw)
    assert int(cg) > 0


@pytest.mark.parametrize("cap", [0, 7, 1 << 16])
def test_minhash_keep_kernel_matches_plain(cuda, cap):
    """Kernel M against the plain version on counts around the threshold:
    the same kept pairs and count (exact past the capacity)."""
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    rng = np.random.default_rng(9)
    n, b, e = 600, 200, 350
    sizes = torch.from_numpy(rng.integers(0, 400, size=n)).to(cuda)
    thr = 0.05 * (sizes[b:e, None] + sizes[None, :]).double()
    C = (thr.floor() + torch.from_numpy(rng.integers(-1, 3, size=(e - b, n)))
         .to(cuda)).clamp(min=0).to(torch.int32)
    C = torch.cat([C, torch.zeros((2, n), dtype=torch.int32, device=cuda)])
    got, gk = mh.keep_shard(C, sizes, b, e, cap)
    want, wk = mh.keep_shard_plain(C, sizes, b, e, max(cap, 1 << 16))
    assert torch.equal(gk, wk) and int(wk) > 100
    m = min(cap, int(wk))
    assert set(map(tuple, got[:m].cpu().tolist())) <= \
        set(map(tuple, want[:int(wk)].cpu().tolist()))
    if cap >= int(wk):
        assert sorted(map(tuple, got[:m].cpu().tolist())) == \
            sorted(map(tuple, want[:m].cpu().tolist()))


@pytest.mark.parametrize("heavy_min", [2, 5, 1 << 20])
def test_minhash_shard_cuda_equals_cpu(cuda, tmp_path, heavy_min,
                                      monkeypatch):
    """A MinHash shard of shared-hash sets on the card, with every hash
    heavy, a mix, and every hash light, byte-equal to the CPU's."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        write_hashes_file)
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    rng = np.random.default_rng(12)
    pool = rng.choice(1 << 40, size=3000, replace=False)
    named = [(f"S{i}", np.unique(np.concatenate([
        rng.choice(pool[:50 + 60 * (i % 7)], size=rng.integers(0, 40)),
        rng.integers(1 << 41, 1 << 50, size=rng.integers(0, 200))])))
        for i in range(300)]
    path = str(tmp_path / "h.txt")
    write_hashes_file(path, named)
    monkeypatch.setattr(mh, "heavy_threshold", lambda p, n: heavy_min)
    mc.clear_device_cache()
    _build.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        for k in range(3):
            mc.compute_minhash_shard(path, str(tmp_path / dev), 3, k,
                                     verbose=False, device=dev)
    mc.clear_device_cache()
    launches = _build.launch_counts()
    assert launches["mhkeep"] == 3
    assert (launches["gram"] > 0) == (heavy_min < 1 << 20)
    assert (launches["cooc"] > 0) == (heavy_min > 2)
    for k in range(3):
        for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
            assert filecmp.cmp(tmp_path / "cpu" / f"shard_{k}" / f,
                               tmp_path / "cuda" / f"shard_{k}" / f,
                               shallow=False)


@pytest.mark.parametrize("offset", [128, -256, 256, -128])
def test_sweep_diag_offset_matches_plain(cuda, offset):
    """Kernel S APPEND on two windows of one db (rows a.. and a + offset..)
    with the self mask at diag_offset: equal to the plain version, and the
    masked pairs are exactly the global self-pairs."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    _, _, planes, thr = _state(cuda, N=1024, d=200, max_abs=3000)
    a, b = 256, 256 + offset
    pi, ti = planes[:, a:a + 512].contiguous(), thr[a:a + 512].contiguous()
    pj, tj = planes[:, b:b + 512].contiguous(), thr[b:b + 512].contiguous()
    coords = np.array([(r, c) for r in range(4) for c in range(4)])
    cap = 1 << 16
    key = lambda rc, n: set(map(tuple, rc[:n].tolist()))  # noqa: E731
    got = pw.sweep_extract(pi, ti, pj, tj, coords, 128, cap, True, 200,
                           offset)
    want = pw.sweep_extract_plain(pi, ti, pj, tj, coords, 128, cap, True,
                                  200, offset)
    n = int(want[2].item())
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert key(got[0], n) == key(want[0], n)
    every = pw.sweep_extract(pi, ti, pj, tj, coords, 128, cap, False, 200)
    m = int(every[2].item())
    selfs = {(r, c) for r, c in key(every[0], m) if a + r == b + c}
    assert len(selfs) == 512 - abs(offset)
    assert key(got[0], n) == key(every[0], m) - selfs


def test_streaming_cuda_shard_equals_resident(cuda, tmp_path):
    """device_budget_bytes=0 forces the streaming engine (8 row groups x 8
    windows at tile 256); its shard equals the resident one, byte for
    byte."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    V, _, _, _ = _state("cpu", N=4096, d=200, max_abs=3000)
    V[3000:3010] = V[5]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(4096)],
                        V, 200)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "res"), tile_rows=256,
                              verbose=False, device=cuda)
    _build.reset_launch_counts()
    mc.compute_pairwise_shard(db.path, str(tmp_path / "stream"),
                              tile_rows=256, device_budget_bytes=0,
                              verbose=False, device=cuda)
    launches = _build.launch_counts()
    assert mc.LAST_STAGES["mode"] == "fused-streaming"
    assert mc.LAST_STAGES["row_groups"] == 8 and mc.LAST_STAGES["windows"] == 8
    assert launches["sweep"] > 0 and launches["keep"] > 0
    assert launches["partials"] == 0
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert filecmp.cmp(tmp_path / "res" / "shard_0" / f,
                           tmp_path / "stream" / "shard_0" / f,
                           shallow=False)


@pytest.mark.parametrize("bj", [512, 256, 128])
@pytest.mark.parametrize("bi", [512, 256, 128])
@pytest.mark.parametrize("max_abs", [3000, 30000])
def test_count_tiles_kernel_matches_plain(cuda, max_abs, bi, bj):
    """The two-phase engine's COUNT (count_tiles: kernel COUNT, the tile
    list on the card) equals its plain version swept at (bi, bj)
    sub-blocks, one and two operands, P = 3 and 6."""
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    _, _, planes, thr = _state(cuda, N=1024, d=200, max_abs=max_abs)
    coords = np.array([(r, c) for r in range(2) for c in range(2)])
    got = pp.count_tiles(planes, thr, planes, thr,
                         pp.TileList(coords, cuda), 512, 200)
    want = pp.count_tiles_plain(planes.cpu(), thr.cpu(), planes.cpu(),
                                thr.cpu(), coords, 512, 200, (bi, bj))
    assert int(want.sum()) > 0 and torch.equal(got.cpu(), want)
    # the row tile rows 512.. against a window of rows 256..
    pi, ti = planes[:, 512:].contiguous(), thr[512:].contiguous()
    pj, tj = planes[:, 256:768].contiguous(), thr[256:768].contiguous()
    got = pp.count_tiles(pi, ti, pj, tj, [(0, 0)], 512, 200)
    want = pp.count_tiles_plain(pi.cpu(), ti.cpu(), pj.cpu(), tj.cpu(),
                                [(0, 0)], 512, 200, (bi, bj))
    assert torch.equal(got.cpu(), want)


def _count_state(dev, P, n, d, seed=0):
    """(planes, thr) on ``dev`` at P = 1, 3, 6 or 10 planes, n rows, with
    planted near-duplicates; the last 100 rows are pad rows (zero planes,
    t = 1e30)."""
    max_abs = {1: 40, 3: 3000, 6: 30000, 10: 2000000}[P]
    _, L, planes, thr = _state(dev, N=n, d=d, max_abs=max_abs, seed=seed)
    assert planes.shape[0] == P
    planes[:, n - 100:] = 0
    thr[n - 100:] = 1e30
    return planes, thr


@pytest.mark.parametrize("edge", [128, 384, 2048])
@pytest.mark.parametrize("P", [1, 3, 6, 10])
def test_count_kernel_matches_plain(cuda, P, edge):
    """Kernel COUNT equals its plain version exactly at tile edges 128 (a
    work item with three dead quarters), 384 (odd: dead halves) and 2048
    (32 items a tile; more items than the card holds clusters at once):
    count_tiles over every tile in a shuffled order, sweep_counts over row
    ranges and over rectangular tiles; pad rows never count."""
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    n, d = 2 * max(edge, 768), 200
    planes, thr = _count_state(cuda, P, n, d, seed=P)
    nt = n // edge
    coords = np.array([(r, c) for r in range(nt) for c in range(nt)])
    coords = coords[np.random.default_rng(edge).permutation(len(coords))]
    got = pp.count_tiles(planes, thr, planes, thr, coords, edge, d)
    want = pp.count_tiles_plain(planes, thr, planes, thr, coords, edge, d)
    assert int(want.sum()) > 0 and torch.equal(got, want)
    for r0, r1 in ((0, None), (1, nt)):
        assert torch.equal(
            pp.sweep_counts(planes, thr, d, r0, r1, edge),
            pp.sweep_counts_plain(planes, thr, d, r0, r1, edge))
    if edge < 2048:
        kw = dict(row_t0=1, block=edge, block_j=2 * edge) \
            if n % (2 * edge) == 0 else dict(block=2 * edge, block_j=edge)
        assert torch.equal(pp.sweep_counts(planes, thr, d, **kw),
                           pp.sweep_counts_plain(planes, thr, d, **kw))


def test_count_kernel_two_operands_many_items(cuda):
    """The streaming engine's operands (a row tile, a window of column
    tiles that starts elsewhere) and a list of 600 tiles, repeats
    included, far more work items than clusters: equal to the plain
    version; counts sum only their own tile's survivors."""
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    planes, thr = _count_state(cuda, 3, 2048, 128, seed=4)
    pi, ti = planes[:, 256:512].contiguous(), thr[256:512].contiguous()
    pj, tj = planes[:, 768:].contiguous(), thr[768:].contiguous()
    win = pp.TileList([(0, j) for j in range(5)], cuda)
    for _ in range(2):                     # one list, several sweeps
        got = pp.count_tiles(pi, ti, pj, tj, win, 256, 128)
        assert torch.equal(got, pp.count_tiles_plain(
            pi, ti, pj, tj, win.host, 256, 128))
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 8, size=(600, 2))
    want = pp.count_tiles_plain(planes, thr, planes, thr, np.unique(
        coords, axis=0), 256, 128)
    lookup = {tuple(c): int(w) for c, w in zip(np.unique(coords, axis=0),
                                               want.tolist())}
    got = pp.count_tiles(planes, thr, planes, thr, coords, 256, 128)
    assert got.tolist() == [lookup[tuple(c)] for c in coords]


def test_count_kernel_two_streams(cuda):
    """Two COUNT launches on two streams at once (each its own list and
    operands; one busy stream behind a sleep) both equal the plain
    version."""
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    a = _count_state(cuda, 3, 2048, 256, seed=6)
    b = _count_state(cuda, 6, 1024, 256, seed=7)
    ca = pp.TileList([(r, c) for r in range(4) for c in range(4)], cuda)
    cb = pp.TileList([(r, c) for r in range(2) for c in range(2)], cuda)
    want_a = pp.count_tiles_plain(*a, *a, ca.host, 512, 256)
    want_b = pp.count_tiles_plain(*b, *b, cb.host, 512, 256)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        torch.cuda._sleep(50_000_000)
        got_a = pp.count_tiles(*a, *a, ca, 512, 256)
    with torch.cuda.stream(s2):
        got_b = pp.count_tiles(*b, *b, cb, 512, 256)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)


def test_count_kernel_refuses_bad_input(cuda):
    """Tiles that are not multiples of 128, tiles outside the planes and
    a list on another device than the planes raise; no launch counted."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    planes, thr = _count_state(cuda, 3, 512, 64)
    _build.reset_launch_counts()
    with pytest.raises(ValueError):
        pp.count_tiles(planes, thr, planes, thr, [(0, 0)], 192, 64)
    with pytest.raises(ValueError):
        pp.count_tiles(planes, thr, planes, thr, [(2, 0)], 256, 64)
    with pytest.raises(ValueError):
        pp.count_tiles(planes, thr, planes, thr, pp.TileList([(0, 0)], "cpu"),
                       256, 64)
    with pytest.raises(ValueError):
        pp.sweep_counts(planes, thr, 64, block=64)
    assert _build.launch_counts()["count"] == 0


def _same_append(got, want):
    """APPEND's (rc, counts, total) equal the plain version's: the same
    total and per-tile counts, the same survivor set (the kernel's order
    is unspecified)."""
    n = int(want[2].item())
    assert int(got[2].item()) == n
    assert torch.equal(got[1], want[1])
    assert _survivors(got[0], n) == _survivors(want[0], n)
    return n


@pytest.mark.parametrize("edge", [128, 384, 2048])
@pytest.mark.parametrize("P", [1, 3, 6, 10])
def test_append_kernel_matches_plain(cuda, P, edge):
    """Kernel APPEND equals its plain version exactly at tile edges 128 (a
    work item with three dead quarters), 384 (odd: dead halves) and 2048,
    P = 1, 3, 6 and 10, every tile in a shuffled order, self-pairs masked
    and kept; pad rows (t = 1e30) never pass; with the mask off its
    per-tile counts equal kernel COUNT's on the same TileList."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    n, d = 2 * max(edge, 768), 200
    planes, thr = _count_state(cuda, P, n, d, seed=P)
    nt = n // edge
    coords = np.array([(r, c) for r in range(nt) for c in range(nt)])
    coords = coords[np.random.default_rng(edge).permutation(len(coords))]
    tiles = pw.TileList(coords, cuda)
    cap = 1 << 22
    for mask in (True, False):
        _build.reset_launch_counts()
        got = pw.sweep_extract(planes, thr, planes, thr, tiles, edge, cap,
                               mask, d)
        assert _build.launch_counts()["sweep"] == 1
        want = pw.sweep_extract_plain(planes, thr, planes, thr, coords, edge,
                                      cap, mask, d)
        assert _same_append(got, want) > 0
        rows = got[0][:int(got[2].item())]
        assert bool((rows < n - 100).all())          # no pad row passes
    assert torch.equal(got[1], pp.count_tiles(planes, thr, planes, thr,
                                              tiles, edge, d))


def test_append_kernel_cap_overflow(cuda):
    """Past its capacity APPEND writes exactly `cap` survivors, all of
    them survivors and none twice, and still returns the exact total and
    per-tile counts (the engine's rerun at the exact total)."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    planes, thr = _count_state(cuda, 3, 1024, 200, seed=8)
    coords = [(r, c) for r in range(4) for c in range(r, 4)]
    want = pw.sweep_extract_plain(planes, thr, planes, thr, coords, 256,
                                  1 << 20, True, 200)
    n = int(want[2].item())
    everyone = _survivors(want[0], n)
    for cap in (0, 1, n // 3, n - 1, n):
        rc, counts, total = pw.sweep_extract(planes, thr, planes, thr,
                                             coords, 256, cap, True, 200)
        assert int(total.item()) == n and torch.equal(counts, want[1])
        assert rc.shape == (cap, 2)
        got = _survivors(rc, cap)
        assert len(got) == cap and got <= everyone


def test_append_kernel_two_operands_many_items(cuda):
    """The streaming engine's operands (a row tile, a window that starts
    elsewhere) with the self mask at their diagonal offset, and 600 tiles
    of a two-operand list (repeats included; swept as two ranges of one
    TileList on the card): equal to the plain version."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    planes, thr = _count_state(cuda, 3, 2048, 128, seed=4)
    pi, ti = planes[:, 256:512].contiguous(), thr[256:512].contiguous()
    pj, tj = planes[:, 128:].contiguous(), thr[128:].contiguous()
    win = pw.TileList([(0, j) for j in range(7)], cuda)
    for _ in range(2):                     # one list, several sweeps
        _same_append(pw.sweep_extract(pi, ti, pj, tj, win, 256, 1 << 20,
                                      True, 128, -128),
                     pw.sweep_extract_plain(pi, ti, pj, tj, win.host, 256,
                                            1 << 20, True, 128, -128))
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 7, size=(600, 2))
    pb = planes[:, 128:].contiguous()
    tb = thr[128:].contiguous()
    tiles = pw.TileList(coords, cuda)
    for a, b in ((0, 250), (250, 600)):
        _same_append(pw.sweep_extract(planes, thr, pb, tb, tiles[a:b], 256,
                                      1 << 22, True, 128, 128),
                     pw.sweep_extract_plain(planes, thr, pb, tb, coords[a:b],
                                            256, 1 << 22, True, 128, 128))


def test_append_kernel_two_streams(cuda):
    """Two APPEND launches on two streams at once (each its own list,
    operands and buffers; one stream behind a sleep) both equal the plain
    version."""
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    a = _count_state(cuda, 3, 2048, 256, seed=6)
    b = _count_state(cuda, 6, 1024, 256, seed=7)
    ca = pw.TileList([(r, c) for r in range(4) for c in range(r, 4)], cuda)
    cb = pw.TileList([(r, c) for r in range(2) for c in range(2)], cuda)
    want_a = pw.sweep_extract_plain(*a, *a, ca.host, 512, 1 << 20, True, 256)
    want_b = pw.sweep_extract_plain(*b, *b, cb.host, 512, 1 << 20, False,
                                    256)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        torch.cuda._sleep(50_000_000)
        got_a = pw.sweep_extract(*a, *a, ca, 512, 1 << 20, True, 256)
    with torch.cuda.stream(s2):
        got_b = pw.sweep_extract(*b, *b, cb, 512, 1 << 20, False, 256)
    torch.cuda.synchronize()
    _same_append(got_a, want_a)
    _same_append(got_b, want_b)


def test_append_kernel_refuses_bad_input(cuda):
    """Tiles that are not multiples of 128, tiles outside the planes, a
    list on another device than the planes, a negative capacity, planes
    of another P or d_pad and a d past d_pad raise; no launch counted."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    planes, thr = _count_state(cuda, 3, 512, 64)
    other, other_thr = _count_state(cuda, 6, 512, 64)
    wide, wide_thr = _count_state(cuda, 3, 512, 200)
    _build.reset_launch_counts()
    bad = [
        dict(coords=[(0, 0)], tile=192),
        dict(coords=[(2, 0)], tile=256),
        dict(coords=pw.TileList([(0, 0)], "cpu"), tile=256),
        dict(coords=[(0, 0)], tile=256, cap=-1),
        dict(coords=[(0, 0)], tile=256, d=65),
        dict(coords=[(0, 0)], tile=256, j=(other, other_thr)),
        dict(coords=[(0, 0)], tile=256, j=(wide, wide_thr)),
        dict(coords=[(0, 0)], tile=256, j=(planes, thr[:256])),
    ]
    for case in bad:
        pj, tj = case.get("j", (planes, thr))
        with pytest.raises(ValueError):
            pw.sweep_extract(planes, thr, pj, tj, case["coords"],
                             case["tile"], case.get("cap", 16), True,
                             case.get("d", 64))
    assert _build.launch_counts()["sweep"] == 0


@pytest.mark.parametrize("case", ["host", "device", "streaming", "2 slots",
                                  "tile 384", "tile 256", "int16"])
def test_two_phase_cuda_shard_equals_fused(cuda, tmp_path, case):
    """engine="two_phase" on the card (COUNT sweep, APPEND extraction with
    self-pairs kept, host or device finalize) writes the fused shard's
    bytes: finalize host and device, streaming, two slots of cuda:0,
    tiles of 384 and 256 (the JAX engine's 128- and 256-row blocks), and
    an int16 db at P = 6 (JAX's (512, 128) blocks). COUNT is launched and
    nothing reruns."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    int16 = case == "int16"
    tile = {"tile 384": 384, "tile 256": 256}.get(case, 512)
    V, _, _, _ = _state("cpu", N=2500, d=200,
                        max_abs=30000 if int16 else 3000)
    V[2000:2010] = V[5]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(2500)],
                        V, 200, use_int16=int16)
    P = pm.num_planes(pm.pick_limbs(int(np.abs(V).max())))
    want_blocks = {"tile 384": (128, 128), "tile 256": (256, 256),
                   "int16": (512, 128)}.get(case, (512, 512))
    assert P == (6 if int16 else 3)
    assert pp.engine_blocks(P, tile, cuda) == want_blocks
    kw = dict(engine="two_phase", finalize="host" if case == "host"
              else None)
    if case == "streaming":
        kw["device_budget_bytes"] = 0
    if case == "2 slots":
        kw["mesh"] = Mesh([torch.device("cuda", 0)] * 2)
    mc.clear_device_cache()
    for s in range(2):
        mc.compute_pairwise_shard(db.path, str(tmp_path / "fused"), 2, s,
                                  tile_rows=tile, verbose=False, device=cuda)
    for s in range(2):
        _build.reset_launch_counts()
        mc.compute_pairwise_shard(db.path, str(tmp_path / "two"), 2, s,
                                  tile_rows=tile, verbose=False, device=cuda,
                                  **kw)
        launches = _build.launch_counts()
        assert mc.LAST_STAGES["mode"] == (
            "two_phase-streaming" if case == "streaming" else "two_phase")
        assert mc.LAST_STAGES["reruns"] == 0
        assert launches["count"] > 0 and launches["sweep"] > 0
        assert (launches["partials"] > 0) == (case != "host")
    mc.clear_device_cache()
    _same_shard_files(tmp_path / "fused", tmp_path / "two", (0, 1))


def test_minhash_cli_cuda_equals_cpu(cuda, tmp_path):
    import filecmp
    import pathlib
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.cli import pairwise_comp
    toy = pathlib.Path(__file__).parent / "fixtures" / "ref_toy"
    _build.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        assert pairwise_comp.main(
            ["--db", str(toy / "toy_db_256"), "--max_memory_gb", "1",
             "--num_threads", "1", "--output_folder", str(tmp_path / dev),
             "--num_shards", "1", "--shard_idx", "0", "--strategy", "1",
             "--hashes", str(toy / "all_hashes_toy.txt"),
             "--device", dev]) == 0
    assert _build.launch_counts()["mhkeep"] > 0
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert filecmp.cmp(tmp_path / "cpu" / "shard_0" / f,
                           tmp_path / "cuda" / "shard_0" / f, shallow=False)


def _cache_db(path, seed, n=8192, d=1024):
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    rng = np.random.default_rng(seed)
    V = rng.integers(-2000, 2001, size=(n, d)).astype(np.int32)
    V[1] = V[0]
    return DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d)


def test_held_slot_of_another_db_does_not_force_streaming(cuda, tmp_path,
                                                          monkeypatch):
    """The residency slot holding another db's planes is evicted (and its
    memory handed back to the driver) before the free memory is read: with
    the card's free memory faked so that the budget fits the new planes
    only without the held ones, the new db still runs resident, and its
    shard equals a fresh run's."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    mc.clear_device_cache()
    a, b = _cache_db(tmp_path / "a", 1), _cache_db(tmp_path / "b", 2)
    mc.compute_pairwise_shard(a.path, str(tmp_path / "ma"), verbose=False,
                              device=cuda)
    held = mc._RESIDENT["value"][0]
    S = held.numel()
    torch.cuda.synchronize()
    real = torch.cuda.mem_get_info
    # with a's planes held the faked free memory is S / 2 (budget 0.4 S:
    # b would stream); a's eviction frees at least S more (budget >= 1.2 S)
    offset = real(cuda)[0] - S // 2
    del held
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *x: (real(*x)[0] - offset, real(*x)[1]))
    mc.compute_pairwise_shard(b.path, str(tmp_path / "mb"), verbose=False,
                              device=cuda)
    assert mc.LAST_STAGES["mode"] == "fused"
    assert mc._RESIDENT["key"][0] == os.path.abspath(
        os.path.join(b.path, "vectors.bin"))
    monkeypatch.undo()
    mc.clear_device_cache()
    mc.compute_pairwise_shard(b.path, str(tmp_path / "fresh"), verbose=False,
                              device=cuda)
    mc.clear_device_cache()
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert filecmp.cmp(tmp_path / "mb" / "shard_0" / f,
                           tmp_path / "fresh" / "shard_0" / f, shallow=False)


def test_residency_cache_hit_on_cuda(cuda, tmp_path):
    """Shard 1 of 2 re-uses shard 0's planes on the card (no staging) and
    is byte-equal to shard 1 staged afresh."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    mc.clear_device_cache()
    db = _cache_db(tmp_path / "db", 3)
    kw = dict(num_shards=2, verbose=False, device=cuda)
    mc.compute_pairwise_shard(db.path, str(tmp_path / "hit"), shard_idx=0,
                              **kw)
    planes = mc._RESIDENT["value"][0]
    _build.reset_launch_counts()
    mc.compute_pairwise_shard(db.path, str(tmp_path / "hit"), shard_idx=1,
                              **kw)
    assert mc._RESIDENT["value"][0] is planes
    assert mc.LAST_STAGES["stage_h2d_ms"] == 0
    assert _build.launch_counts()["sweep"] > 0
    del planes
    mc.clear_device_cache()
    mc.compute_pairwise_shard(db.path, str(tmp_path / "fresh"), shard_idx=1,
                              **kw)
    mc.clear_device_cache()
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert filecmp.cmp(tmp_path / "hit" / "shard_1" / f,
                           tmp_path / "fresh" / "shard_1" / f, shallow=False)


def _staging_db(path, int16, n=4096, d=200):
    """A db of five staging chunks (STAGE_CHUNK_BYTES of 900 rows) with a
    group of near-duplicates."""
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    V, _, _, _ = _state("cpu", N=n, d=d, max_abs=30000 if int16 else 3000)
    V[3000:3010] = V[5]
    db = DbFolder.write(str(path), [f"S{i}" for i in range(n)], V, d,
                        use_int16=int16)
    return db, 900 * d * (2 if int16 else 4)


@pytest.mark.parametrize("int16", [False, True])
def test_staged_planes_on_cuda_equal_cpu(cuda, tmp_path, monkeypatch, int16):
    """The pipelined stager on the card (page-locked ring, copy stream,
    five chunks of the file's own dtype) writes the CPU path's planes, byte
    for byte; every host buffer it reads into is page-locked; the copies'
    and the decompositions' device times are > 0; stage_bytes is the
    file."""
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.parallel.engine import (
        MeshSweepOps)
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    db, chunk_bytes = _staging_db(tmp_path / "db", int16)
    monkeypatch.setattr(mc, "STAGE_CHUNK_BYTES", chunk_bytes)
    pinned = []
    real = mc._FileRows.fill

    def spy(self, out, lo, hi):
        pinned.append(torch.from_numpy(out).is_pinned())
        return real(self, out, lo, hi)
    monkeypatch.setattr(mc._FileRows, "fill", spy)
    n, d = db.total_vectors_from_bin(), db.dimension
    max_abs = mc.scan_max_abs(db)
    L = pm.pick_limbs(max_abs)
    planes = []
    for dev in (torch.device("cpu"), cuda):
        mc.clear_device_cache()
        mc._reset_stages()
        pinned.clear()
        ops = MeshSweepOps(Mesh([dev]))
        slots, _ = mc._stage_database(db, np.ones(n), n, 256, L, d,
                                      max_abs, ops, ("staging", dev.type))
        planes.append(slots[0].cpu())
        assert pinned and all(pinned) == (dev.type == "cuda")
        st = mc.LAST_STAGES
        assert st["stage_bytes"] == n * d * (2 if int16 else 4)
        assert st["stage_h2d_ms"] > 0 and st["stage_decompose_ms"] > 0
        assert st["stage_read_ms"] > 0
    mc.clear_device_cache()
    assert len(pinned) >= 5
    assert torch.equal(planes[0], planes[1])


@pytest.mark.parametrize("int16", [False, True])
def test_resident_streaming_two_phase_equal_over_chunks(cuda, tmp_path,
                                                        monkeypatch, int16):
    """Staged through five chunks, a resident shard, a streaming shard
    (device_budget_bytes=0) and a two-phase shard of one db are byte-equal
    on the card."""
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    db, chunk_bytes = _staging_db(tmp_path / "db", int16)
    monkeypatch.setattr(mc, "STAGE_CHUNK_BYTES", chunk_bytes)
    runs = {"resident": {}, "streaming": {"device_budget_bytes": 0},
            "two_phase": {"engine": "two_phase"}}
    for name, kw in runs.items():
        mc.clear_device_cache()
        for s in range(2):
            mc.compute_pairwise_shard(db.path, str(tmp_path / name), 2, s,
                                      tile_rows=512, verbose=False,
                                      device=cuda, **kw)
    mc.clear_device_cache()
    for name in ("streaming", "two_phase"):
        _same_shard_files(tmp_path / "resident", tmp_path / name, (0, 1))


# ---------------------------------------------------------------------------
# the multi-device layer: slots of one card, and a second card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda1():
    """The second card; skips on a host with fewer than two."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: torch.cuda.device_count() < 2")
    return torch.device("cuda", 1)


def _same_shard_files(a, b, shards=(0,)):
    import filecmp
    for s in shards:
        for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
            assert filecmp.cmp(a / f"shard_{s}" / f, b / f"shard_{s}" / f,
                               shallow=False), (s, f)


def _mesh_shards(tmp_path, devices, budget):
    """Shards 0 and 1 of 2 of a P = 3 db over a mesh of ``devices`` and on
    the first device alone (resident, or streaming with budget 0)."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    V, _, _, _ = _state("cpu", N=1500, d=200, max_abs=3000)
    V[1000:1010] = V[5]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(1500)],
                        V, 200)
    mesh = Mesh(devices)
    kw = dict(tile_rows=128, verbose=False, device_budget_bytes=budget)
    mc.clear_device_cache()
    _build.reset_launch_counts()
    for s in range(2):
        mc.compute_pairwise_shard(db.path, str(tmp_path / "mesh"), 2, s,
                                  mesh=mesh, device=devices[0], **kw)
    launches = _build.launch_counts()
    assert launches["sweep"] > 0 and launches["keep"] > 0
    mc.clear_device_cache()
    for s in range(2):
        mc.compute_pairwise_shard(db.path, str(tmp_path / "single"), 2, s,
                                  device=devices[0], **kw)
    mc.clear_device_cache()
    _same_shard_files(tmp_path / "mesh", tmp_path / "single", (0, 1))


@pytest.mark.parametrize("budget", [None, 0])
def test_mesh_two_slots_of_one_card_equal_single(cuda, tmp_path, budget):
    """Two slots of cuda:0, each on its own stream: resident and streaming
    shards byte-equal to the single-device ones."""
    _mesh_shards(tmp_path, [torch.device("cuda", 0)] * 2, budget)


def test_distributed_on_two_slots_of_one_card(cuda, tmp_path):
    """The distributed int8 index (from a built index and straight from a
    db folder), the f32 top-k and the pipeline step over two slots of
    cuda:0: equal to the single-device index and to the CPU mesh."""
    from metagenome_vector_sketches_tpu_torch.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu_torch.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    from metagenome_vector_sketches_tpu_torch.ann.int_index import (
        IntExactIndex)
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    from metagenome_vector_sketches_tpu_torch.parallel.pairwise import (
        distributed_topk)
    from metagenome_vector_sketches_tpu_torch.parallel.pipeline import (
        make_pipeline_step)
    mesh = Mesh([torch.device("cuda", 0)] * 2)
    rng = np.random.default_rng(71)
    V = rng.integers(-3000, 3001, size=(1100, 200)).astype(np.int32)
    V[700] = V[3]
    Q = rng.integers(-3000, 3001, size=(37, 200)).astype(np.int32)
    Q[0] = V[3]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(1100)],
                        V, 200)
    single = IntExactIndex(V, chunk_rows=300, device=cuda)
    Ds, Is = single.search(Q, 40)
    for dist in (DistributedIntExactIndex.from_index(single, mesh=mesh),
                 DistributedIntExactIndex.from_dbfolder(db.path, mesh=mesh,
                                                        chunk_rows=256)):
        D, I = dist.search(Q, 40)
        assert np.array_equal(I, Is) and np.array_equal(D, Ds)
    assert Is[0, :2].tolist() == [3, 700]
    Vf = normalize_l2(V.astype(np.float32))
    Qf = normalize_l2(Q.astype(np.float32))
    Df, If = FlatIPIndex(Vf, device=cuda).search(Qf, 10)
    D, I = distributed_topk(mesh, torch.from_numpy(Qf).to(cuda),
                            torch.from_numpy(Vf).to(cuda), 10)
    scores = Qf.astype(np.float64) @ Vf.astype(np.float64).T
    for b in range(len(Q)):
        got, want = set(I[b].tolist()), set(If[b].tolist())
        if got != want:
            np.testing.assert_allclose(np.sort(scores[b][list(got)]),
                                       np.sort(scores[b][list(want)]),
                                       rtol=1e-6)
    np.testing.assert_allclose(np.sort(D.cpu().numpy(), axis=1),
                               np.sort(Df, axis=1), rtol=0, atol=1e-6)
    hi = rng.integers(0, 1 << 32, size=(64, 300), dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, size=(64, 300), dtype=np.uint64)
    hi[1], lo[1] = hi[0], lo[0]
    counts = rng.integers(1, 301, size=64).astype(np.int32)
    counts[1] = counts[0]
    args = (hi.astype(np.uint32), lo.astype(np.uint32), counts)
    s_g, _, _ = make_pipeline_step(mesh, 256, 2, 5)(*args)
    s_c, _, _ = make_pipeline_step(Mesh(["cpu"] * 2), 256, 2, 5)(*args)
    assert torch.equal(s_g.cpu(), s_c) and bool((s_c[:2] >= 2).all())


def test_slot_results_are_handed_off_before_a_gather(cuda, monkeypatch):
    """A slot's results reach the current stream only after the slot's
    stream has made them. Each check runs twice: a warm-up on other values
    loads every kernel (a kernel's first launch loads its module, which
    waits for the whole device) and leaves stale values in the blocks the
    allocator hands out next. Then slot 1 (first through
    Mesh.gather_slots), or every slot of the pipeline step (after kernel
    P), sleeps on its stream before it writes, so a gather that did not
    wait for the slots would read stale values. The step's survivors and
    top-k must equal the CPU mesh's."""
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    from metagenome_vector_sketches_tpu_torch.parallel.pipeline import (
        make_pipeline_step)
    dev = torch.device("cuda", 0)
    mesh = Mesh([dev] * 2)
    n = 1 << 22

    def gathered(base, cycles):
        parts = []
        for s in range(2):
            with mesh.slot(s):
                if s == 1:
                    torch.cuda._sleep(cycles)
                parts.append(torch.arange(n, dtype=torch.int32, device=dev)
                             * 3 + base + s)
        return mesh.gather_slots(parts)

    gathered(0, 1)
    torch.cuda.synchronize()
    want = torch.cat([torch.arange(n, dtype=torch.int32) * 3 + 10 + s
                      for s in range(2)])
    assert torch.equal(gathered(10, 200_000_000).cpu(), want)

    def batch(seed):
        rng = np.random.default_rng(seed)
        hi = rng.integers(0, 1 << 32, size=(64, 300), dtype=np.uint64)
        lo = rng.integers(0, 1 << 32, size=(64, 300), dtype=np.uint64)
        return (hi.astype(np.uint32), lo.astype(np.uint32),
                rng.integers(1, 301, size=64).astype(np.int32))

    args = batch(72)
    s_c, i_c, d_c = make_pipeline_step(Mesh(["cpu"] * 2), 256, 2, 5)(*args)
    step = make_pipeline_step(mesh, 256, 2, 5)
    step(*batch(73))
    torch.cuda.synchronize()
    project = pj.project_batch

    def delayed(*a, **kw):
        vecs = project(*a, **kw)
        torch.cuda._sleep(100_000_000)
        return vecs.clone()                  # written after the sleep

    monkeypatch.setattr(pj, "project_batch", delayed)
    s_g, i_g, d_g = step(*args)
    assert torch.equal(s_g.cpu(), s_c)
    assert torch.equal(i_g[:, 0].cpu(), torch.arange(64, dtype=torch.int32))
    np.testing.assert_allclose(d_g.cpu().numpy(), d_c.numpy(), rtol=0,
                               atol=1e-5)


def test_each_kernel_launches_on_the_second_card(cuda1, tmp_path):
    """Kernels P, COUNT, S (APPEND, SCORE), X, G, C, M and K launched on
    cuda:1 with cuda:0 current for PyTorch: every output lies on cuda:1 and
    equals the plain version; the current device is left as it was. Then a
    mesh over cuda:0 and cuda:1 writes the single-device shards."""
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    torch.cuda.set_device(0)
    _build.reset_launch_counts()
    _project_both(cuda1, [0, 1, 31, 1000, 7], 2048)
    _, L, planes, thr = _state(cuda1, max_abs=3000)
    assert torch.equal(pp.sweep_counts(planes, thr, 200, block=128),
                       pp.sweep_counts_plain(planes, thr, 200, block=128))
    coords = np.array([(r, c) for r in range(4) for c in range(r, 4)])
    got = pp.count_tiles(planes, thr, planes, thr, pp.TileList(coords, cuda1),
                         128, 200)
    assert got.device == cuda1 and torch.equal(got, pp.count_tiles_plain(
        planes, thr, planes, thr, coords, 128, 200))
    got = pw.sweep_extract(planes, thr, planes, thr, coords, 128, 1 << 16,
                           True, 200)
    want = pw.sweep_extract_plain(planes, thr, planes, thr, coords, 128,
                                  1 << 16, True, 200)
    n = int(want[2].item())
    assert got[0].device == cuda1 and torch.equal(got[2], want[2])
    assert _survivors(got[0], n) == _survivors(want[0], n)
    rc = torch.randint(0, 512, (3000, 2), dtype=torch.int32, device=cuda1)
    flag = pw.range_flag(cuda1)
    parts = pw.pair_partials(planes, rc, L, flag=flag)
    pw.check_range_flag(flag)
    assert parts.device == cuda1
    assert torch.equal(parts, pw.pair_partials_plain(planes, rc, L))
    ns = torch.rand(512, dtype=torch.float64, device=cuda1) * 1e6
    keep = pw.Retention(ns, 200, False, 100, 400, 500)
    got = pw.pair_keep(planes, rc, L, keep, 3000, twins=(128, 0, 4))
    want = pw.pair_keep_plain(planes, rc, L, keep, 3000, twins=(128, 0, 4))
    n = int(want[1][0])
    assert got[0].device == cuda1 and torch.equal(got[1], want[1])
    assert _survivors(got[0], n) == _survivors(want[0], n)
    _, qp, db, inv = _scan_state(cuda1, 1000, 200, 3000, 37, seed=5)
    assert torch.equal(pw.scan_scores(qp, db, inv, 1000),
                       pw.scan_scores_plain(qp, db, inv, 1000))
    A = _padded_incidence(cuda1, 300, 1000, 0.05, 3)
    C = mh.gram_rows(A, 100, 300)
    assert C.device == cuda1
    assert torch.equal(C[:200], mh.gram_rows_plain(A, 100, 300))
    sets, off = _postings(cuda1, 300, 500, 20, seed=3)
    want = C.clone()
    cg = torch.zeros(1, dtype=torch.int64, device=cuda1)
    cw = torch.zeros_like(cg)
    mh.cooc_accumulate(C, sets, off, 100, 300, cg)
    mh.cooc_accumulate_plain(want, sets, off, 100, 300, cw)
    assert torch.equal(C, want) and torch.equal(cg, cw)
    sizes = torch.full((300,), 40, dtype=torch.int64, device=cuda1)
    got, gk = mh.keep_shard(C, sizes, 100, 300, 1 << 16)
    want, wk = mh.keep_shard_plain(C, sizes, 100, 300, 1 << 16)
    assert got.device == cuda1 and torch.equal(gk, wk)
    assert sorted(map(tuple, got[:int(wk)].tolist())) == \
        sorted(map(tuple, want[:int(wk)].tolist()))
    scores = _select_scores(cuda1, 37, 2048, 2000, seed=6)
    best = _select_pool(cuda1, 37, 16, seed=7)
    got = sel.select_chunk(scores, 0, 2000, 2048, 16, best, 16)
    want = sel.select_chunk_plain(scores, 0, 2000, 2048, 16, best, 16)
    assert all(g.device == cuda1 and torch.equal(g, w)
               for g, w in zip(got, want))
    keys = torch.cat([best, got[0]], dim=1)
    assert all(torch.equal(g, w) for g, w in zip(
        sel.select_keys(keys, 20), sel.select_keys_plain(keys, 20)))
    torch.cuda.synchronize(cuda1)
    assert torch.cuda.current_device() == 0
    assert all(v > 0 for v in _build.launch_counts().values())
    _mesh_shards(tmp_path, [torch.device("cuda", 0), cuda1], None)
