"""Kernel X's retention epilogue (ops.pairwise.pair_keep), its plain
PyTorch version on the CPU, against the host path it replaced in the fused
engine (tests/keep_cases.py: kernel X's partials, the int64 combine, the
host finalize's range filter and exact test, the resident engine's mirror
selection): the same kept pairs, the same counts, on random and
adversarial candidates. Exact: the test is int64 and float64 in the same
rounded steps on both paths."""

import numpy as np
import pytest
import torch

from keep_cases import CASES, host_path, keep, make_case, retention
from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc
from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
from metagenome_vector_sketches_tpu_torch.parallel.engine import MeshSweepOps
from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_pair_keep_plain_matches_host_path(dtype, L, case):
    """Random planes of L limbs; the adversarial cases: dots whose quotient
    lands on the threshold (not kept) or one ulp above it (kept); negative
    dots between the truncated and the floored quotient; int16 dots whose
    double quotient rounds down onto the threshold; twins on tile edges; a
    shard that starts and ends inside a tile; columns on the zero padding
    rows past the db; two operands with their own first global rows."""
    c = make_case(case, dtype == "int16", L, seed=L)
    want, candidates, emitted = host_path(c)
    got, kept, em, bad = keep(c, cap=2 * len(c["rc"]))
    assert got == want
    assert (kept, em, bad) == (len(want), emitted, 0)
    assert candidates == len(c["rc"]) and emitted > 0
    for a, b, dot, kept_ in c["adversarial"]:
        assert ((a, b, dot) in got) == kept_
    if case in ("on_threshold", "negative_dots"):
        # both outcomes occur on the boundary
        assert {k for *_, k in c["adversarial"]} == \
            ({True} if case == "negative_dots" and dtype == "int32"
             else {False} if case == "negative_dots" else {True, False})


def test_pair_keep_counts_past_its_capacity_and_out_of_range():
    """kept counts past the buffer (read_kept refuses the short buffer; a
    rerun at the exact size holds every pair); out-of-range candidates
    write nothing and are counted, and read_kept raises on them."""
    c = make_case("random", False, 2)
    want, _, emitted = host_path(c)
    out, counters = pw.pair_keep(c["planes"], c["rc"], 2, retention(c), 5,
                                 twins=c["twins"])
    counts = counters.numpy()
    assert counts.tolist() == [len(want), emitted, 0] and len(want) > 5
    with pytest.raises(RuntimeError, match="kept pairs in a buffer of 5"):
        pw.read_kept(out, counts)
    assert keep(c, cap=len(want))[0] == want
    bad = torch.cat([c["rc"], torch.tensor([[320, 0], [0, -1]],
                                           dtype=torch.int32)]).contiguous()
    out, counters = pw.pair_keep(c["planes"], bad, 2, retention(c), 10**4,
                                 twins=c["twins"])
    assert counters.numpy().tolist() == [len(want), emitted, 2]
    with pytest.raises(ValueError, match="2 candidate pair"):
        pw.read_kept(out, counters.numpy())


def test_mesh_pair_keep_reruns_a_slot_at_its_exact_count():
    """MeshSweepOps.pair_keep on 2 CPU slots: each slot's kept pairs, the
    first buffer far too small, equal the host path's on its survivors."""
    c = make_case("tile_edges", True, 3)
    rc = c["rc"]
    half = len(rc) // 2
    ops = MeshSweepOps(Mesh(["cpu", "cpu"]))
    swept = [(rc[:half].contiguous(), half),
             (rc[half:].contiguous(), len(rc) - half)]
    keeps = [retention(c)] * 2
    kept, emitted, nbytes = ops.pair_keep((c["planes"],) * 2, swept, 3,
                                          keeps, 1, twins=c["twins"])
    want = [host_path(dict(c, rc=r)) for r, _ in swept]
    for (r, cc, dots), (w, _, _) in zip(kept, want):
        assert len(w) > 1
        assert set(zip(r.tolist(), cc.tolist(), dots.tolist())) == w
    assert emitted == sum(e for _, _, e in want)
    # each slot's kept pairs, and its counters twice (the rerun's too)
    assert nbytes == sum(len(w) * pw.KEPT_BYTES + 2 * pw.COUNTER_BYTES
                         for w, _, _ in want)


@pytest.mark.parametrize("engine", ["resident", "streaming"])
@pytest.mark.parametrize("dtype", ["int32", "int16"])
def test_fused_engine_counts_equal_the_host_path(tmp_path, monkeypatch,
                                                 engine, dtype):
    """The fused engine's candidates, emitted and pairs_written on a shard
    that starts inside a tile equal the host path's on the same survivors
    (every call of kernel X's retention replayed through it), and its kept
    pairs are the host path's."""
    rng = np.random.default_rng(7)
    n, d = 230, 64
    V = rng.integers(-3000, 3001, size=(n, d)).astype(np.int32)
    V[20:80] = np.clip(V[5] + rng.integers(-3, 4, size=(60, d)), -3000, 3000)
    V[100:110] = V[70]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)], V,
                        d, use_int16=dtype == "int16")
    seen = {"kept": set(), "candidates": 0, "emitted": 0, "copies": 0}
    real = MeshSweepOps.pair_keep

    def spy(self, planes, swept, L, keeps, cap, planes_j=None, row_base=0,
            col_base=0, twins=None):
        k = keeps[0]
        for s, run in enumerate(swept):
            if run is not None:
                w, cand, em = host_path(dict(
                    planes=planes[s], rc=run[0][:run[1]], L=L,
                    ns=k.ns.numpy(), d=k.d, int16=k.int16,
                    begin_row=k.begin_row, end_row=k.end_row,
                    total=k.total, row_base=row_base, col_base=col_base,
                    planes_j=None if planes_j is None else planes_j[s],
                    twins=twins))
                seen["kept"] |= w
                seen["candidates"] += cand
                seen["emitted"] += em
                seen["copies"] += 1
        return real(self, planes, swept, L, keeps, cap, planes_j, row_base,
                    col_base, twins)
    monkeypatch.setattr(MeshSweepOps, "pair_keep", spy)
    kw = {"device_budget_bytes": 0} if engine == "streaming" else {}
    tmc.clear_device_cache()
    tmc.compute_pairwise_shard(db.path, str(tmp_path / "m"), num_shards=3,
                               shard_idx=1, tile_rows=32, verbose=False,
                               device="cpu", **kw)
    st = tmc.LAST_STAGES
    assert st["mode"] == ("fused" if engine == "resident"
                          else "fused-streaming")
    assert st["candidates"] == seen["candidates"] > 0
    assert st["emitted"] == seen["emitted"]
    assert st["pairs_written"] == len(seen["kept"]) > 0
    # the kept pairs and one copy of the counters a slot and call
    assert st["readback_bytes"] == pw.KEPT_BYTES * len(seen["kept"]) \
        + pw.COUNTER_BYTES * seen["copies"]
