"""The exact MinHash shard engine (ops.minhash: staged sets split into a
heavy incidence and light postings, a shard's rows only) on the CPU,
through its plain kernels: shard folders byte-equal to the JAX package's
compute_minhash_shard and equal to the benchmark's plain reference
(portbench/reference/minhash.py) on seeded sets that share hashes by Zipf
popularity, at every split of the hashes, with empty, duplicated and
single-hash sets, over 1 to 3 shards; the staged-sets slot; and the work of
a shard, which grows with its rows and not with N^2."""

import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io.hashes import (  # noqa: E402
    parse_hashes_file, write_hashes_file)
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import minhash as tmh  # noqa: E402
from portbench import gen_hashes  # noqa: E402
from portbench.reference import minhash as ref  # noqa: E402
from portbench.reference import shardfmt  # noqa: E402

SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
# every hash heavy, a mix, every hash light
SPLITS = [2, 6, 1 << 30]


def _cfg(n=160, pool=1 << 12):
    return {"num_sets": n,
            "set_sizes": {"law": "log_uniform", "low": 1, "high": 600},
            "planted": {"share_of_rows": 0.25, "group": 4, "shared": 160,
                        "of": 256},
            "sharing": {"share": 0.5, "pool_size": pool,
                        "zipf_exponent": 0.99}}


@pytest.fixture(scope="module")
def zipf_file(tmp_path_factory):
    """A seeded collection that shares hashes by Zipf popularity, written
    as all_hashes.txt -> (path, its sets as the reference holds them)."""
    sets = gen_hashes.make_sets(_cfg(), 2**31 + 17, "cpu")
    path = str(tmp_path_factory.mktemp("zipf") / "all_hashes.txt")
    gen_hashes.write_hashes_text(path, sets)
    return path, ref.Sets(sets["hashes"], sets["offsets"])


def _edge_file(path):
    """Empty, duplicated (the same set twice) and single-hash sets among
    sets that share hashes."""
    rng = np.random.default_rng(5)
    common = rng.choice(1 << 40, size=40, replace=False)
    named = []
    for i in range(30):
        h = np.concatenate([rng.choice(common, size=rng.integers(0, 30)),
                            rng.integers(1 << 41, 1 << 50, size=10 * (i % 4))])
        named.append((f"E{i:02d}", np.unique(h)))
    named[3] = ("E03", np.empty(0, dtype=np.int64))
    named[9] = ("E09", named[8][1])
    named[17] = ("E17", common[:1])
    named[18] = ("E18", common[:1])
    named[25] = ("E25", np.array([1 << 45]))
    named.append(("E30", np.empty(0, dtype=np.int64)))
    write_hashes_file(path, named)
    return path


def _shards(hashes, out, num_shards, heavy_min, monkeypatch, db=None):
    monkeypatch.setattr(tmh, "heavy_threshold", lambda p, n: heavy_min)
    for k in range(num_shards):
        jmc.compute_minhash_shard(hashes, str(out / "jax"), num_shards, k,
                                  db_folder=db, verbose=False)
        tmc.compute_minhash_shard(hashes, str(out / "port"), num_shards, k,
                                  db_folder=db, verbose=False, device="cpu")
        assert tmc.LAST_STAGES["mode"] == "minhash"


def _same(out, num_shards):
    for k in range(num_shards):
        for f in SHARD_FILES:
            assert filecmp.cmp(out / "jax" / f"shard_{k}" / f,
                               out / "port" / f"shard_{k}" / f,
                               shallow=False), (k, f)


@pytest.mark.parametrize("heavy_min", SPLITS)
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_zipf_shards_equal_jax_and_the_reference(tmp_path, zipf_file,
                                                 heavy_min, num_shards,
                                                 monkeypatch):
    path, sets = zipf_file
    tmc.clear_device_cache()
    _shards(path, tmp_path, num_shards, heavy_min, monkeypatch)
    _same(tmp_path, num_shards)
    per = (sets.n + num_shards - 1) // num_shards
    for k in range(num_shards):
        shard = shardfmt.Shard(str(tmp_path / "port" / f"shard_{k}"))
        rows = np.arange(k * per, min((k + 1) * per, sets.n))
        for r, (cols, q) in zip(rows, ref.shard_rows(sets, rows)):
            got_c, got_q = shard.row(r)
            assert np.array_equal(got_c, cols) and np.array_equal(got_q, q)


@pytest.mark.parametrize("heavy_min", SPLITS)
@pytest.mark.parametrize("num_shards", [1, 3])
def test_edge_sets_equal_jax(tmp_path, heavy_min, num_shards, monkeypatch):
    path = _edge_file(str(tmp_path / "edge.txt"))
    tmc.clear_device_cache()
    _shards(path, tmp_path, num_shards, heavy_min, monkeypatch)
    _same(tmp_path, num_shards)
    for f in ("vector_norms.txt", "dimension.txt", "dtype.txt"):
        assert filecmp.cmp(tmp_path / "jax" / "minhash_db" / f,
                           tmp_path / "port" / "minhash_db" / f,
                           shallow=False)


@pytest.mark.parametrize("heavy_min", SPLITS)
def test_toy_shards_in_db_order_equal_jax(tmp_path, ref_toy_dir, heavy_min,
                                          monkeypatch):
    """The toy fixture's 61 real accessions in toy_db_256's order."""
    tmc.clear_device_cache()
    _shards(str(ref_toy_dir / "all_hashes_toy.txt"), tmp_path, 2, heavy_min,
            monkeypatch, db=str(ref_toy_dir / "toy_db_256"))
    _same(tmp_path, 2)


def test_the_split_holds_every_shared_hash_once(zipf_file, monkeypatch):
    """Staging drops the hashes of one set and puts each other hash in
    exactly one class: heavy columns plus light postings are the distinct
    hashes held by two or more sets, and the light members their
    holders."""
    _, sets = zipf_file
    _, counts = torch.unique(sets.hashes, return_counts=True)
    named = [sets.hashes[sets.offsets[i]:sets.offsets[i + 1]].numpy()
             .view(np.uint64) for i in range(sets.n)]
    for heavy_min in SPLITS:
        monkeypatch.setattr(tmh, "heavy_threshold",
                            lambda p, n, t=heavy_min: t)
        st = tmh.stage_sets(named, device="cpu")
        assert st.heavy_min == heavy_min
        heavy = counts >= heavy_min
        light = (counts >= 2) & ~heavy
        assert st.n_heavy == int(heavy.sum())
        assert st.n_post == int(light.sum())
        assert len(st.post_sets) == int(counts[light].sum())
        if st.heavy is not None:
            assert int(st.heavy.sum()) == int(counts[heavy].sum())
        assert np.array_equal(st.sizes.numpy(), np.diff(sets.offsets.numpy()))


# posting lengths: 100 of 50 sets, 30 of 40, 200 of 12, 50 of 3, 10 of 2
POSTINGS = [50] * 100 + [40] * 30 + [12] * 200 + [3] * 50 + [2] * 10


@pytest.mark.parametrize("n,cap,want", [
    (24576, None, 256), (24577, None, 257), (160, None, 2), (0, None, 2),
    (960, 128, 41), (960, 64, 51)])
def test_heavy_threshold_follows_n_under_the_memory_cap(monkeypatch, n, cap,
                                                        want):
    """Postings of at least N / 96 sets go heavy, never fewer than 2; where
    their incidence would pass HEAVY_BYTES (here ``cap`` columns of N),
    only the longest do, less those tied with the first left out."""
    if cap:
        monkeypatch.setattr(tmh, "HEAVY_BYTES", n * cap)
    p = torch.tensor(POSTINGS)
    t = tmh.heavy_threshold(p, n)
    assert t == want
    if cap:
        assert int((p >= t).sum()) * n <= tmh.HEAVY_BYTES


def test_shard_work_grows_with_its_rows_not_n_squared(zipf_file,
                                                      monkeypatch, tmp_path):
    """Each shard tests its own rows x N pairs, forms kernel G's rows for
    its own rows only, and kernel C makes one increment a (member in its
    rows, member) pair: over the job the increments add up to the light
    postings' sum of p_h^2 once, whatever the number of shards."""
    path, sets = zipf_file
    shapes = []
    real = tmh.gram_rows_plain

    def rows_seen(A, b, e):
        shapes.append((e - b, A.shape[0]))
        return real(A, b, e)
    monkeypatch.setattr(tmh, "gram_rows_plain", rows_seen)
    _, counts = torch.unique(sets.hashes, return_counts=True)
    heavy_min = 6
    monkeypatch.setattr(tmh, "heavy_threshold", lambda p, n: heavy_min)
    light = (counts >= 2) & (counts < heavy_min)
    want = int((counts[light] ** 2).sum())
    for num_shards in (1, 4):
        tmc.clear_device_cache()
        shapes.clear()
        per = (sets.n + num_shards - 1) // num_shards
        incs, emitted = [], []
        for k in range(num_shards):
            tmc.compute_minhash_shard(path, str(tmp_path / str(num_shards)),
                                      num_shards, k, verbose=False,
                                      device="cpu")
            st = tmc.LAST_STAGES
            rows = min(per, sets.n - k * per)
            assert st["emitted"] == rows * sets.n
            incs.append(st["light_cooccurrences"])
            emitted.append(st["emitted"])
        assert sum(incs) == want
        assert sum(emitted) == sets.n ** 2
        assert shapes == [(min(per, sets.n - k * per), sets.n)
                          for k in range(num_shards)]
        if num_shards == 4:
            assert max(incs) < want


def test_sets_are_staged_once_a_process(tmp_path, zipf_file, monkeypatch):
    """The second shard of a file reuses the slot: no parse, stage_ms 0 and
    no bytes; another file evicts it; clear_device_cache empties it."""
    path, _ = zipf_file
    parses = []
    real = tmc.parse_hashes_file
    monkeypatch.setattr(tmc, "parse_hashes_file",
                        lambda p: parses.append(p) or real(p))
    tmc.clear_device_cache()
    tmc.compute_minhash_shard(path, str(tmp_path / "a"), 2, 0, verbose=False,
                              device="cpu")
    first = dict(tmc.LAST_STAGES)
    tmc.compute_minhash_shard(path, str(tmp_path / "a"), 2, 1, verbose=False,
                              device="cpu")
    assert len(parses) == 1
    assert first["stage_bytes"] > 0 and tmc.LAST_STAGES["stage_bytes"] == 0
    assert tmc.LAST_STAGES["stage_ms"] < first["stage_ms"]
    other = _edge_file(str(tmp_path / "edge.txt"))
    tmc.compute_minhash_shard(other, str(tmp_path / "b"), verbose=False,
                              device="cpu")
    assert len(parses) == 2 and tmc._SETS["key"][0].endswith("edge.txt")
    tmc.clear_device_cache()
    assert not tmc._SETS


def test_parse_of_the_generated_text_returns_the_sets(zipf_file):
    """The benchmark's all_hashes.txt writer and the program's parser agree:
    each line holds its set's hashes, in order."""
    path, sets = zipf_file
    named = parse_hashes_file(path)
    assert [n for n, _ in named] == [f"ACC{i:07d}" for i in range(sets.n)]
    flat = np.concatenate([h for _, h in named]).view(np.int64)
    assert np.array_equal(flat, sets.hashes.numpy())
