"""The port's projection (plain PyTorch path on the CPU) against the JAX
package: splitmix64, the batched projection, and whole db folders against
the reference binaries' toy fixtures. Integer outputs: exact."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.ops.projection import (  # noqa: E402
    project_device_batch, project_host)
from metagenome_vector_sketches_tpu.ops.splitmix import (  # noqa: E402
    split_u64, splitmix64_np)
from metagenome_vector_sketches_tpu_torch.io.ingest import (  # noqa: E402
    project_hash_lines, sketch)
from metagenome_vector_sketches_tpu_torch.ops import projection as pj  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops.splitmix import (  # noqa: E402
    logical_shift_right, splitmix64)


def _sets(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**64, size=n, dtype=np.uint64) for n in sizes]


def test_splitmix64_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**64, size=4096, dtype=np.uint64)
    x[:4] = [0, 2**63, 2**64 - 1, 2**63 - 1]
    got = splitmix64(torch.from_numpy(x.view(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), splitmix64_np(x))


def test_logical_shift_is_unsigned():
    x = np.array([2**64 - 1, 2**63, 12345], dtype=np.uint64)
    for k in (1, 30, 63):
        got = logical_shift_right(torch.from_numpy(x.view(np.int64)), k)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), x >> k)


@pytest.mark.parametrize("d", [64, 100, 256])
def test_project_batch_matches_jax_and_host(d):
    """CSR batch == project_device_batch (zero-padded (hi, lo) batch) ==
    project_host, including an empty set and hashes >= 2^63."""
    sizes = [0, 1, 7, 64, 300, 33]
    sets = _sets(d, sizes)
    flat = np.concatenate(sets)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    got = pj.project_batch(flat.view(np.int64), offsets, d, "cpu")
    assert got.dtype == torch.int32 and got.shape == (len(sets), d)
    H = max(sizes)
    arr = np.zeros((len(sets), H), dtype=np.uint64)
    for i, s in enumerate(sets):
        arr[i, :len(s)] = s
    hi, lo = split_u64(arr)
    want = np.asarray(project_device_batch(
        jnp.asarray(hi), jnp.asarray(lo),
        jnp.asarray(np.array(sizes, dtype=np.int32)), d))
    np.testing.assert_array_equal(got.numpy(), want)
    for i, s in enumerate(sets):
        np.testing.assert_array_equal(got[i].numpy(), project_host(s, d))


def test_project_many_batches_exactly(monkeypatch):
    """Batching is invisible: tiny batch limits give the same matrix."""
    sets = _sets(5, [3, 0, 50, 1, 20, 9])
    whole = pj.project_many(sets, 128, "cpu")
    monkeypatch.setattr(pj, "BATCH_HASHES", 10)
    monkeypatch.setattr(pj, "BATCH_SETS", 2)
    split = pj.project_many(sets, 128, "cpu")
    np.testing.assert_array_equal(whole, split)
    lines = project_hash_lines([list(map(int, s)) for s in sets], 128,
                               device="cpu")
    np.testing.assert_array_equal(lines, whole)


@pytest.mark.parametrize("db,dtype,d", [
    ("toy_db_2048", "int32", 2048),
    ("toy_db_2048_i16", "int16", 2048),
    ("toy_db_256", "int32", 256),
])
def test_db_folder_matches_reference_fixtures(tmp_path, ref_toy_dir, db,
                                              dtype, d):
    """The port's sketch of the reference all_hashes_toy.txt: per accession,
    vectors.bin bytes and norm strings equal the reference binaries'."""
    out = sketch(str(ref_toy_dir / "all_hashes_toy.txt"),
                 str(tmp_path / "db"), d, use_int16=dtype == "int16",
                 device="cpu", verbose=False)
    ref = DbFolder(str(ref_toy_dir / db))
    assert out.dtype == dtype and out.dimension == d
    ref_names, _ = ref.names_and_norms()
    got_names, _ = out.names_and_norms()
    assert sorted(got_names) == sorted(ref_names)
    ref_vecs, got_vecs = ref.load_vectors(), out.load_vectors()
    ri = {n: i for i, n in enumerate(ref_names)}
    for i, name in enumerate(got_names):
        assert got_vecs[i].tobytes() == ref_vecs[ri[name]].tobytes(), name

    def norm_strings(path):
        with open(os.path.join(path, "vector_norms.txt")) as f:
            return {ln.split()[0]: ln.split()[1] for ln in f if ln.strip()}
    assert norm_strings(out.path) == norm_strings(ref.path)


def _toy_sets(ref_toy_dir):
    """The reference toy fixture's 61 real hash sets (3 to 80,772 hashes)."""
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)
    sets = [h for _, h in parse_hashes_file(
        str(ref_toy_dir / "all_hashes_toy.txt"))]
    assert min(map(len, sets)) == 3 and max(map(len, sets)) == 80772
    return sets


# the toy sets by size, so that the JAX batch pads each group to its own
# largest set (one batch of all 61 would pad to 61 x 80,772 slots)
@pytest.mark.parametrize("lo,hi", [(0, 300), (300, 5000), (5000, 1 << 20)])
def test_project_batch_toy_set_sizes_match_jax_and_host(ref_toy_dir, lo, hi):
    """The fixture's real sets (3 to 80,772 hashes, one CSR batch per size
    group) at d = 256: equal to project_device_batch and project_host."""
    d = 256
    sets = [s for s in _toy_sets(ref_toy_dir) if lo < len(s) <= hi]
    sizes = np.array([len(s) for s in sets])
    flat = np.concatenate(sets).astype(np.uint64)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    got = pj.project_batch(flat.view(np.int64), offsets, d, "cpu").numpy()
    arr = np.zeros((len(sets), int(sizes.max())), dtype=np.uint64)
    for i, s in enumerate(sets):
        arr[i, :len(s)] = s
    hi32, lo32 = split_u64(arr)
    want = np.asarray(project_device_batch(
        jnp.asarray(hi32), jnp.asarray(lo32),
        jnp.asarray(sizes.astype(np.int32)), d))
    np.testing.assert_array_equal(got, want)
    for i, s in enumerate(sets):
        np.testing.assert_array_equal(got[i], project_host(s, d))


@pytest.mark.parametrize("chunk", [1, 16, 156, 4095])
def test_chunk_items_cover_every_hash_once(ref_toy_dir, chunk):
    """Kernel P's work items on the toy sizes plus empty sets: each item is
    1..chunk hashes of one set (an empty set one empty item), the items of
    a set tile it in order, and the kernel's grid bound B + H // chunk
    holds."""
    sizes = np.array([0] + [len(s) for s in _toy_sets(ref_toy_dir)] + [0, 0])
    offsets = torch.from_numpy(
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64))
    item_off = pj.chunk_items(offsets, chunk)
    assert item_off.dtype == torch.int64 and int(item_off[0]) == 0
    per_set = np.diff(item_off.numpy())
    np.testing.assert_array_equal(
        per_set, np.maximum(1, -(-sizes // chunk)))
    assert int(item_off[-1]) <= len(sizes) + int(sizes.sum()) // chunk
    set_, start, end = (t.numpy() for t in pj.item_bounds(offsets, item_off,
                                                          chunk))
    assert len(set_) == int(item_off[-1])
    np.testing.assert_array_equal(np.bincount(set_, minlength=len(sizes)),
                                  per_set)
    n = end - start
    assert ((n >= 1) & (n <= chunk) | (sizes[set_] == 0) & (n == 0)).all()
    # in order and back to back: every hash of every set exactly once
    assert (start == np.concatenate([[0], end[:-1]])).all()
    assert end[-1] == sizes.sum()
    o = offsets.numpy()
    assert ((start >= o[set_]) & (end <= o[set_ + 1])).all()


def test_skewed_set_sizes_fill_one_project_many_batch(ref_toy_dir):
    """The skewed timing batch: real toy set sizes, seeded, as many as one
    project_many batch takes."""
    from metagenome_vector_sketches_tpu_torch.bench_data import (
        skewed_set_sizes)
    base = sorted(len(s) for s in _toy_sets(ref_toy_dir))
    sizes = skewed_set_sizes()
    assert set(sizes.tolist()) <= set(base)
    assert len(sizes) <= pj.BATCH_SETS and sizes.sum() <= pj.BATCH_HASHES
    assert sizes.sum() > pj.BATCH_HASHES - base[-1]
    assert np.median(sizes) == np.median(base)
    np.testing.assert_array_equal(sizes, skewed_set_sizes())


def test_project_batch_chunk_is_cuda_only(monkeypatch):
    """The work-item size is kernel P's: the CPU's plain version ignores
    it, and the kernel's wrapper refuses a size outside [1, MAX_CHUNK]
    (the kernel's counters)."""
    sets = _sets(3, [5000, 0, 17])
    flat = torch.from_numpy(np.concatenate(sets).view(np.int64))
    offsets = torch.tensor([0, 5000, 5000, 5017], dtype=torch.int64)
    want = pj.project_batch(flat, offsets, 128, "cpu")
    monkeypatch.setattr(pj, "CHUNK", 7)
    assert torch.equal(pj.project_batch(flat, offsets, 128, "cpu"), want)
    for bad in (0, pj.MAX_CHUNK + 1):
        with pytest.raises(ValueError, match="chunk"):
            pj._project_cuda(flat, offsets, pj.chunk_items(offsets, 7), 128,
                             bad)
