"""The port's shard writer orders its triples without re-sorting what is
already in order: matrix.writer._row_major_order gives np.lexsort's stable
(row, col) permutation, or None for triples already in that order, and
write_shard records which it was (write_presorted) and the walls of its
three stages (write_order_ms, write_quantize_ms, write_codec_ms; spans
mvs.write.order, mvs.write.quantize, mvs.write.codec), each of which times
its own work."""

import time

import numpy as np
import pytest

from metagenome_vector_sketches_tpu_torch.io.hashes import write_hashes_file
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc
from metagenome_vector_sketches_tpu_torch.matrix import writer


def _ids(kind, rng):
    n = 5_000
    r = rng.integers(0, 300, size=n)
    c = rng.integers(0, 700_000, size=n)
    if kind == "sorted":
        o = np.lexsort((c, r))
        r, c = r[o], c[o]
    elif kind == "duplicates":
        # every pair three times over, then shuffled: the stable order of
        # equal pairs is their input order
        r, c = np.tile(r[:200], 3), np.tile(c[:200], 3)
        p = rng.permutation(len(r))
        r, c = r[p], c[p]
    elif kind == "sorted_duplicates":
        r, c = np.repeat(np.sort(r[:200]), 3), np.zeros(600, dtype=np.int64)
    elif kind == "key_edges":
        # the packed range's last ids, next to the ones past it
        r = rng.choice([0, 1, writer.KEY_ROWS - 1], size=n)
        c = rng.choice([0, 1, writer.KEY_COLS - 1], size=n)
    elif kind == "col_past_key":
        c[::7] = writer.KEY_COLS
    elif kind == "row_past_key":
        r[::7] = writer.KEY_ROWS
    elif kind == "negative":
        c[::11] = -1
    return r.astype(np.int64), c.astype(np.int64)


@pytest.mark.parametrize("kind", ["random", "sorted", "duplicates",
                                  "sorted_duplicates", "key_edges",
                                  "col_past_key", "row_past_key",
                                  "negative"])
def test_order_is_lexsorts(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    r, c = _ids(kind, rng)
    want = np.lexsort((c, r))
    got = writer._row_major_order(r, c)
    if kind in ("sorted", "sorted_duplicates"):
        assert got is None
        np.testing.assert_array_equal(want, np.arange(len(r)))
    else:
        assert got is not None
        np.testing.assert_array_equal(got, want)


def test_order_of_nothing_and_of_one():
    e = np.empty(0, dtype=np.int64)
    assert writer._row_major_order(e, e) is None
    one = np.array([5], dtype=np.int64)
    assert writer._row_major_order(one, one) is None


def _triples(n=64, seed=1):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n * n, size=600))
    r, c = keys // n, keys % n
    v = rng.integers(1, 4000, size=len(r)).astype(np.int64) * 16
    return r, c, v, rng.uniform(1000.0, 5000.0, size=n)


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_write_shard_records_whether_it_sorted(tmp_path, order):
    r, c, v, ns = _triples()
    if order == "shuffled":
        p = np.random.default_rng(2).permutation(len(r))
        r, c, v = r[p], c[p], v[p]
    record = {}
    writer.write_shard(str(tmp_path / "s"), r, c, v, ns, 16, record=record)
    assert record["write_presorted"] == int(order == "sorted")
    assert record["write_order_ms"] >= 0.0
    # without a record the writer writes the same files
    writer.write_shard(str(tmp_path / "t"), r, c, v, ns, 16)
    for f in ("matrix.bin", "row_index.bin", "neighbor_start.bin"):
        assert (tmp_path / "s" / f).read_bytes() \
            == (tmp_path / "t" / f).read_bytes()


@pytest.mark.parametrize("step, key", [
    ("_row_major_order", "write_order_ms"),
    ("quantize_jaccard", "write_quantize_ms"),
    ("_write_files", "write_codec_ms")])
def test_each_write_stage_times_its_own_work(tmp_path, monkeypatch, step,
                                             key):
    """A step of the writer made 200 ms slower shows in its own stage's wall
    and in no other's."""
    r, c, v, ns = _triples()
    real = getattr(writer, step)

    def slow(*a, **kw):
        time.sleep(0.2)
        return real(*a, **kw)
    monkeypatch.setattr(writer, step, slow)
    record = {}
    writer.write_shard(str(tmp_path / "s"), r, c, v, ns, 16, record=record)
    walls = ("write_order_ms", "write_quantize_ms", "write_codec_ms")
    assert record[key] >= 200.0
    assert all(record[k] < 200.0 for k in walls if k != key), record


def test_minhash_shard_hands_the_writer_sorted_pairs(tmp_path, monkeypatch):
    """The MinHash engine sorts its kept pairs before the readback, so its
    shards' writer sorts nothing."""
    sets = [np.arange(i, i + 60, dtype=np.uint64) for i in range(0, 300, 9)]
    path = str(tmp_path / "h.txt")
    write_hashes_file(path, [(f"S{i}", s) for i, s in enumerate(sets)])
    monkeypatch.setattr(tmc.minhash, "heavy_threshold", lambda p, n: 4)
    tmc.clear_device_cache()
    try:
        for k in range(3):
            tmc.compute_minhash_shard(path, str(tmp_path / "m"), 3, k,
                                      verbose=False, device="cpu")
            st = tmc.LAST_STAGES
            assert st["pairs_written"] > 0
            assert st["write_presorted"] == 1
            assert 0.0 <= st["write_order_ms"] <= st["write_ms"]
    finally:
        tmc.clear_device_cache()
