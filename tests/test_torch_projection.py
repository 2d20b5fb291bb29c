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
