"""The dense deployment (portbench/configs/study_i32_d2048.json: related
runs that share hashes by Zipf popularity, so that about a third of all
pairs pass) through the port's shard engine on the CPU, at 512 sets and
d = 256: every kept pair, its exact dot and its quantised value equal the
benchmark's plain reference (portbench/reference/exact.py); the shard
folders are byte-equal to the JAX engine's; and with small buffers both
of the fused sweep's reruns (kernel APPEND's survivors, kernel X's kept
pairs) happen, are counted, and leave the folders unchanged."""

import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402
from portbench import gen, gen_hashes  # noqa: E402
from portbench.reference import exact, shardfmt  # noqa: E402

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench", "configs",
    "study_i32_d2048.json")
SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
N, D, SHARDS, TILE = 512, 256, 4, 64


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """The configuration's generator at N sets, projected at d = D by the
    reference and written as a db folder, and the JAX engine's shards of
    it -> (db path, the JAX shards' folder)."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(num_vectors=N, dimension=D)
    sets = gen_hashes.make_sets(dict(cfg, num_sets=N), 2**31 + 2424, "cpu")
    V = exact.project(sets["hashes"].numpy().view(np.uint64),
                      sets["offsets"].numpy(), D, "cpu")
    root = tmp_path_factory.mktemp("study")
    db = str(root / "db")
    gen.write_db(db, V, "int32")
    for k in range(SHARDS):
        jmc.compute_pairwise_shard(db, str(root / "jax"), num_shards=SHARDS,
                                   shard_idx=k, tile_rows=TILE,
                                   verbose=False)
    return db, root / "jax"


def _port(db, out, monkeypatch):
    """The port's shards of the db -> per shard (LAST_STAGES, the triples
    (rows, cols, dots) it handed the writer)."""
    triples = []
    real = tmc.write_shard

    def write(folder, rows, cols, vals, *a, **kw):
        triples.append((np.asarray(rows), np.asarray(cols),
                        np.asarray(vals)))
        return real(folder, rows, cols, vals, *a, **kw)
    monkeypatch.setattr(tmc, "write_shard", write)
    tmc.clear_device_cache()
    stages = []
    for k in range(SHARDS):
        tmc.compute_pairwise_shard(db, str(out), num_shards=SHARDS,
                                   shard_idx=k, tile_rows=TILE,
                                   verbose=False, device="cpu")
        assert tmc.LAST_STAGES["mode"] == "fused"
        stages.append(dict(tmc.LAST_STAGES))
    tmc.clear_device_cache()
    return list(zip(stages, triples))


def _assert_same_bytes(jax_out, port_out):
    for k in range(SHARDS):
        for f in SHARD_FILES:
            a = os.path.join(jax_out, f"shard_{k}", f)
            b = os.path.join(port_out, f"shard_{k}", f)
            assert filecmp.cmp(a, b, shallow=False), f"shard {k} {f}"


def _rows_of(k):
    per = (N + SHARDS - 1) // SHARDS
    return np.arange(k * per, min((k + 1) * per, N))


def test_dense_shards_equal_the_reference(study, tmp_path, monkeypatch):
    db, _ = study
    got = _port(db, tmp_path / "port", monkeypatch)
    ref = gen.read_db(db, "cpu")
    V, ns = ref["V"], ref["ns"]
    ops = exact.operand(V, "exact")
    kept = 0
    for k, (st, (r, c, v)) in enumerate(got):
        rows = _rows_of(k)
        # every kept pair and its exact dot
        dots = exact.dots(ops[torch.from_numpy(rows)], ops)
        keep = exact.retained(dots, torch.from_numpy(
            0.05 * (ns[rows][:, None] + ns[None, :])), D, "int32")
        i, j = torch.nonzero(keep, as_tuple=True)
        want = np.stack([rows[i.numpy()], j.numpy(), dots[i, j].numpy()])
        have = np.stack([r, c, v])
        have = have[:, np.lexsort((have[1], have[0]))]
        assert np.array_equal(have, want), f"shard {k}"
        # every written record and its quantised values
        shard = shardfmt.Shard(str(tmp_path / "port" / f"shard_{k}"))
        for row, (cols, q) in zip(rows, exact.shard_rows(V, rows, ns, D,
                                                         "int32")):
            got_c, got_q = shard.row(row)
            assert np.array_equal(got_c, cols) and np.array_equal(got_q, q)
        assert st["pairs_written"] == len(r)
        # no buffer overflowed at this size: nothing ran twice
        assert st["sweep_reruns"] == 0 and st["keep_reruns"] == 0
        kept += len(r)
    # the dense regime: far more than 1 / KEEP_SHARE of all pairs are kept
    assert kept / N**2 > 4.0 / tmc.KEEP_SHARE


def test_dense_shards_byte_equal_the_jax_engine(study, tmp_path,
                                                monkeypatch):
    db, jax_out = study
    _port(db, tmp_path / "port", monkeypatch)
    _assert_same_bytes(jax_out, tmp_path / "port")


def test_both_reruns_happen_and_change_nothing(study, tmp_path, monkeypatch):
    """Buffers below a dense shard's counts: kernel APPEND's survivors
    overflow the sweep's first capacity, and the kept pairs overflow kernel
    X's buffer (its capacity 1 / KEEP_SHARE of the candidates); each slot
    range runs again at its exact count, counted once a rerun, and the
    shards are still the JAX engine's, byte for byte."""
    db, jax_out = study
    monkeypatch.setattr(tmc, "SWEEP_CAP_START", 64)
    monkeypatch.setattr(tmc, "KEEP_CAP_START", 16)
    got = _port(db, tmp_path / "port", monkeypatch)
    for st, (r, _, _) in got:
        assert st["candidates"] > 64
        assert len(r) > st["candidates"] // tmc.KEEP_SHARE
        assert st["sweep_reruns"] >= 1 and st["keep_reruns"] >= 1
    _assert_same_bytes(jax_out, tmp_path / "port")
