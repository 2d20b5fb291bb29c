#!/usr/bin/env python3
"""GPU correctness smoke test of the PyTorch/CUDA port
(metagenome_vector_sketches_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # N = 65,536 accessions, d = 2048
    python3 chip_smoke.py --n 262144

It builds the port's CUDA kernels from csrc/ (nvcc, sm_90a) and checks,
phase by phase, that every path gives the exact answer on the card. It
times nothing: the benchmark (BENCHMARK.json, portbench/) measures the
port.

1. kernels: each kernel against its plain PyTorch version on the card,
   with exact equality (projection P, the counts sweep COUNT over row
   ranges, rectangular tiles and a tile list on two operands, the sweep
   with survivor compaction APPEND (COUNT's second epilogue, csrc/count.cu)
   with a nonzero diagonal offset and past its cap, its counts against
   COUNT's, partials X and its retention epilogue, incidence Gram G at
   ragged n and u), and the TMA/wgmma cores of COUNT, APPEND and S at the
   edges of their contracts (d_pad 64, 192, 2048; P = 1, 3, 6, 10; 128-row
   and 128 x 256 tiles; diag_offset +-128; SCORE at B = 1 and 256 with a
   ragged valid count; G at n = 128, 384), and the selection K bit-equal
   (keys, lanes, merged keys, positions) in each of its regimes (two-stage
   over one and five tiles a row, one CTA a row, the multi-CTA radix
   select, the full sort), with valid < R, all -inf rows and rows of one
   score (the survivor overflow), ties straddling 128-lane blocks, B = 1
   and 256, an empty and a full running pool, strided and unaligned rows,
   and on its key entry;
2. main: the main path at N accessions x d = 2048 — synthetic hash sets
   with planted groups -> sketch (P) -> one pairwise shard (APPEND, X) ->
   top-k queries of planted rows; planted recall must be 1.0, an exact
   numpy oracle must agree on sampled rows, and every kernel's launch
   count over that run must be > 0. Then P, APPEND and X against their
   plain versions at the main path's shapes (P also on a skewed batch:
   the toy fixture's real set sizes, 3 to 80,772 hashes, filling one
   project_many batch);
3. cli: the README walkthrough through the port's command-line tools at
   N = 2048 on an int32 and an --int16 db, every output held against an
   exact numpy oracle — sketch, pairwise_comp (also with --finalize device
   and --gate_sparse_tiles, byte-equal to the default run, and
   --strategy 1 against an exact set-Jaccard oracle), query_pc_mat, and
   step 5: jaccard index / search (f32 and int8 engines) / test;
4. ann: ANN serving at the JAX package's ANN-at-scale size
   (benchmarks/ann_scale.py): N = 1,048,576 x d = 2048 int32 sketch-like
   vectors made on the card with planted groups of 4, the int8-plane
   engine (scan S + selection K + X) and the f32 engine built from device
   chunks (float32 product + K); planted recall 1.0 for both, the int8
   engine's (D, I) equal to a float64 brute force on the card, the f32
   engine within 1e-5 of it, one adaptive search per engine, the scan,
   selection and two-operand partials kernels against their plain versions
   at the path's shapes (K at the int8 and f32 searches' pools, adaptive
   level 4 and kc = R);
5. stream: the beyond-memory streaming engine on phase 2's db with the
   device budget at half its planes' bytes (8 row groups x 8 windows at
   N = 65,536): its shard must be byte-equal to phase 2's resident shard;
6. minhash: --strategy 1 (kernel G over the heavy hashes, C over the
   light postings, M's retention) on the toy fixture (every pair's
   intersection against np.intersect1d) and on N = 8,192 synthetic sets (a
   universe of ~2.1M hashes, all light): the shard equal to an exact
   sparse oracle, every planted pair and self-pair present, the same bytes
   with the groups' hashes heavy; then one shard of the benchmark's
   MinHash collection (3,072 rows x 24,576 Zipf-shared sets) staged on the
   card, its counted run launching G, C and M, each against its plain
   version there;
7. tools (after phase 3, on its int32 db and shards): read_pc_mat
   --query_file and the port's read_pc_mat_module (query, query_sliced)
   against the exact oracle and query_pc_mat's top-5 files; the decoded
   triples through the legacy format A and query_ava_matrix (also
   zstd-compressed where a zstd back end loads) and export_npz; the toy
   fixture sketched with --device device (vectors.bin byte-equal) and its
   shard, inside device_trace, equal to compute_pairwise_oracle, the trace
   naming retention_kernel and partials_kernel; the residency cache: shards 0
   and 1 of 2 of phase 2's db in one process, the second's stage_ms under
   5% of the first's, byte-equal to shard 1 staged after
   clear_device_cache();
8. mesh: the multi-device layer on a mesh of two slots of the one card
   (each slot on its own stream): phase 2's shard over the mesh, resident
   and streaming (phase 5's budget), byte-equal to phase 2's shard; a
   DistributedIntExactIndex staged from an int16 db folder of phase 4's
   vectors, its (D, I) equal to the single-device index's; under a
   torch.distributed world of one on NCCL, compute_pairwise_multihost with
   num_shards=2 (byte-equal to the single-device shards 0 and 1), the f32
   distributed top-k (equal to the flat index's up to ties) and the
   pipeline step on 4,096 of phase 2's sets (survivors equal to a plain
   count, top-k equal to a plain float32 top-k up to ties), each repeated
   call's result checked. Two cards, NCCL between them and launches on
   cuda:1 need a second card (tests/test_torch_gpu.py).
9. two_phase (after phase 5, on phase 2's db): compute_pairwise_shard
   with engine="two_phase" (the path of the JAX package's one Pallas
   kernel: kernel COUNT over the full rectangle, hot-tile extraction
   through APPEND with self-pairs kept, exact finalize) resident with
   finalize="device" and "host", streaming at phase 5's budget and on a
   mesh of two slots of cuda:0, each shard byte-equal to phase 2's fused
   shard; COUNT and APPEND launched in every run, no reruns; the host
   finalize after a fused shard of the same db re-uses its staged planes;
   COUNT and APPEND (self-pairs kept) on 16 tiles of 2048^2 at P = 3
   (phase 2's rows) and P = 6 (an int16-like db) against their plain
   versions and APPEND's counts against COUNT's.

Each path's kernels must be launched in that path's counted run (counts
set to 0 just before it, read just after). At the end no module of jax or
of the JAX package (metagenome_vector_sketches_tpu) may be loaded. Any
failure raises (exit code != 0). On success the last two lines of stdout
are a JSON object with the per-kernel results (launches, max_abs_err) and
{"ok": true, "device": {...}}. Without CUDA it exits with 1 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
D = 2048
PKG = "metagenome_vector_sketches_tpu_torch"
REPLACES = {
    "projection": "metagenome_vector_sketches_tpu/ops/projection.py:107",
    "sweep": "metagenome_vector_sketches_tpu/ops/pairwise.py:635",
    "partials": "metagenome_vector_sketches_tpu/ops/pairwise.py:888",
    "scan": "metagenome_vector_sketches_tpu/ann/int_index.py:124",
    "gram": "metagenome_vector_sketches_tpu/ops/minhash.py:47",
    "select": "metagenome_vector_sketches_tpu/ann/int_index.py:155",
    "count": "metagenome_vector_sketches_tpu/ops/pallas_pairwise.py:55",
    "keep": "metagenome_vector_sketches_tpu/matrix/compute.py:881",
    "cooc": "metagenome_vector_sketches_tpu/ops/minhash.py:55",
    "mhkeep": "metagenome_vector_sketches_tpu/ops/minhash.py:90",
}
SOURCES = {"projection": "projection.cu", "sweep": "count.cu",
           "partials": "partials.cu", "scan": "sweep.cu", "gram": "sweep.cu",
           "select": "select.cu", "count": "count.cu", "keep": "partials.cu",
           "cooc": "minhash.cu", "mhkeep": "minhash.cu"}
SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
# the kernels each counted path must launch
MAIN_KERNELS = ("projection", "sweep", "keep")
ANN_KERNELS = ("scan", "partials", "select")
STREAM_KERNELS = ("sweep", "keep")
MINHASH_KERNELS = ("gram", "cooc", "mhkeep")


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rows_of(rc, n):
    """Survivor pairs of a (cap, 2) buffer as a sorted (n, 2) numpy array."""
    a = rc[:n].cpu().numpy().astype(np.int64)
    return a[np.lexsort((a[:, 1], a[:, 0]))]


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def _sweep_state(N, d, max_abs, seed):
    """Random int32 db with planted near-duplicates -> (V, planes, thr)."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    rng = np.random.default_rng(seed)
    V = rng.integers(-max_abs, max_abs + 1, size=(N, d)).astype(np.int32)
    for g in range(0, N - 8, 97):          # planted groups of 5
        V[g + 1:g + 5] = np.clip(
            V[g] + rng.integers(-3, 4, size=(4, d)), -max_abs, max_abs)
    L = pm.pick_limbs(max_abs)
    planes = torch.zeros((pm.num_planes(L), N, pw.pad_dim(d)),
                         dtype=torch.int8, device="cuda")
    pw.planes_update(planes, pw.decompose_limbs(
        torch.from_numpy(V).cuda(), L), 0)
    ns = np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64)) / d
    return V, L, planes, _row_thresholds(planes, ns, L, d)


def _row_thresholds(planes, norms_sq, L, d):
    """The main path's float32 sweep thresholds of the planes' rows on the
    card: matrix.compute._thresholds from their squared norms and their
    plane energies, so the kernel checks run at the main path's survivor
    density."""
    import torch
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    energies = pw.plane_energies(planes).cpu().numpy()
    return torch.from_numpy(mc._thresholds(
        np.asarray(norms_sq, dtype=np.float64), energies, L, d)[0]).cuda()


def _incidence(n, u, density, seed):
    """(pad_rows(n), u rounded up to 64) int8 0/1 chunk on the card, zero
    padded (kernel G's operand)."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.zeros((pw.pad_rows(n, "cuda"), pw.pad_dim(u)),
                    dtype=torch.int8, device="cuda")
    A[:n, :u] = (torch.rand((n, u), generator=g, device="cuda")
                 < density).to(torch.int8)
    return A


def _gram_rows_err(A, b, e):
    """Max |kernel G - plain| over rows b..e-1 of the incidence A's Gram;
    checks that the kernel's pad rows are 0."""
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    got = mh.gram_rows(A, b, e)
    check(not bool(got[e - b:].any()), "kernel G wrote its pad rows")
    return int((got[:e - b] - mh.gram_rows_plain(A, b, e)).abs().max())


def _core_cases(errs):
    """The TMA/wgmma cores of COUNT, APPEND and S at the edges of their
    contracts, each against the plain version exactly: d_pad 64, 192 (an
    odd number of 64-byte K steps) and 2048; P = 1, 3, 6, 10; COUNT on 128
    x 128, 128 x 256 and 256 x 128 tiles; APPEND on one 128-row tile, the
    128-tile triangle and 128 x 256 tiles; the self mask at diag_offset
    +-128; SCORE at B = 1 and 256 on 640 rows with 555 valid."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ann import int_index as ii
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    cap = 1 << 17

    def same(got, want, what):
        n = int(want[2].item())
        check(int(got[2].item()) == n and torch.equal(got[1], want[1])
              and np.array_equal(rows_of(got[0], n), rows_of(want[0], n)),
              f"APPEND differs from plain ({what})")

    for d in (64, 192, 2048):
        for max_abs in (100, 3000, 30000, 2000000):
            _, _, planes, thr = _sweep_state(512, d, max_abs, seed=d)
            what = f"d={d} P={planes.shape[0]}"
            for blk in ((128, 128), (128, 256), (256, 128)):
                err = int((pp.sweep_counts(planes, thr, d, 0, None, *blk).long()
                           - pp.sweep_counts_plain(planes, thr, d, 0, None,
                                                   *blk).long()).abs().max())
                check(err == 0, f"COUNT differs ({what}, blocks {blk})")
                errs["count"] = max(errs["count"], err)
            for coords in ([(0, 0)], [(r, c) for r in range(4)
                                      for c in range(r, 4)]):
                same(pw.sweep_extract(planes, thr, planes, thr, coords, 128,
                                      cap, True, d),
                     pw.sweep_extract_plain(planes, thr, planes, thr, coords,
                                            128, cap, True, d),
                     f"{what}, {len(coords)} tiles of 128")
            wide = np.array([(r, c) for r in range(4) for c in range(2)])
            counts, rc, total = pw.launch_sweep(
                planes, thr, planes, thr, wide, 128, 256, d, mask_self=True,
                cap=cap)
            want = pw.sweep_extract_plain(
                planes, thr, planes, thr,
                [(r, 2 * c + h) for r, c in wide.tolist() for h in range(2)],
                128, cap, True, d)
            same((rc, want[1], total), want, f"{what}, tiles of 128 x 256")
            check(torch.equal(counts, want[1].view(-1, 2).sum(1)
                              .to(torch.int32)),
                  f"APPEND 128 x 256 tile counts differ ({what})")
            for off in (128, -128):
                a, b = 128, 128 + off
                pi, ti = planes[:, a:a + 256].contiguous(), \
                    thr[a:a + 256].contiguous()
                pj, tj = planes[:, b:b + 256].contiguous(), \
                    thr[b:b + 256].contiguous()
                cc = [(r, c) for r in range(2) for c in range(2)]
                same(pw.sweep_extract(pi, ti, pj, tj, cc, 128, cap, True, d,
                                      off),
                     pw.sweep_extract_plain(pi, ti, pj, tj, cc, 128, cap,
                                            True, d, off),
                     f"{what}, diag_offset {off}")
        rng = np.random.default_rng(d)
        for max_abs in (100, 2000000):
            L = pm.pick_limbs(max_abs)
            V = rng.integers(-max_abs, max_abs + 1, size=(640, d))
            db = ii.query_planes(V.astype(np.int32), L, "cuda")
            inv = torch.from_numpy(rng.random(640).astype(np.float32)).cuda()
            for B in (1, 256):
                Q = rng.integers(-max_abs, max_abs + 1, size=(B, d))
                qp = ii.query_planes(Q.astype(np.int32), L, "cuda")
                got = pw.scan_scores(qp, db, inv, 555)
                check(torch.equal(got, pw.scan_scores_plain(qp, db, inv,
                                                            555)),
                      f"S SCORE differs (d={d} P={db.shape[0]} B={B})")
    say("[kernels] COUNT, APPEND and S cores: d_pad 64/192/2048 x P "
        "1/3/6/10, "
        "COUNT (128^2, 128x256, 256x128 tiles), APPEND (1 tile, triangle, "
        "128x256 tiles, diag_offset +-128), SCORE (B 1/256, 555 of 640 "
        "valid): exact")


def _select_err(got, want, what):
    """Fails unless kernel K's outputs equal the plain version's bit for
    bit -> the largest difference (0): of the lanes / positions, and of
    the scores the keys decode to."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and torch.equal(g, w),
              f"kernel K differs from plain ({what})")
        if g.numel():     # keys (outputs 0, 2) by their decoded scores
            d = (sel.key_scores(g) - sel.key_scores(w)).nan_to_num(0.0) \
                if i % 2 == 0 else (g - w)
            err = max(err, float(d.abs().max()))
    return err


def _select_scores(B, R, valid, seed, all_inf_row=False, equal_row=False):
    """(B, R) float32 scores on the card with large exact-tie classes (+0.0
    and -0.0 among them) and runs of the row maximum across 128-lane
    blocks; -inf past valid; ``equal_row``: the last row one finite
    score."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = torch.randint(-6, 7, (B, R), generator=g, device="cuda") \
        .to(torch.float32) / 4
    S[:, 1::9] = -0.0
    for a, b in ((120, 136), (255, 258), (1023, 1026)):
        S[:, a:min(b, R)] = 2.0
    S[:, valid:] = float("-inf")
    if all_inf_row:
        S[0] = float("-inf")
    if equal_row:
        S[-1] = 0.5
    return S


def _select_cases(errs):
    """Kernel K against its plain version, bit for bit, in each of its
    regimes (ann/select.py::regime): the chunk entry at kc = 1 (two-stage),
    R/128, R/128 + 1 and R (one CTA a row) on 2,048 lanes; kc = 114 of
    40,000 lanes (two-stage over 5 tiles a row); kc = 2,500 of 5,000 and
    5,000 of 20,000 (the multi-CTA radix select and the grid-wide sort); kc
    = R = 20,000 (the full sort); valid < R, fewer valid lanes than kc, an
    all -inf row and, on the wider chunks, a row of one finite score (both
    overflow the two-stage row stage's survivors); B = 1 and 256; an empty
    running pool and a full one (W0 = pool); rows of a wider tensor, one
    slice not 16-byte aligned; then the key entry at W = 228 (a merge's
    width), 7,000, 9,000 (k = 2,100 and k = W) and 40,000 (k = 700)."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    n = 0
    for B in (1, 256):
        for R, kc in ((2048, 1), (2048, 16), (2048, 17), (2048, 2048),
                      (40000, 114), (5000, 2500), (20000, 5000),
                      (20000, 20000)):
            for valid, full in ((R, False), (1500, True), (5, True),
                                (R, True)):
                pool = max(kc, 7)
                S = _select_scores(B, R, valid, seed=B + kc + valid,
                                   all_inf_row=valid == R and full,
                                   equal_row=R > 5000)
                if full:   # the pool a previous chunk's merge leaves
                    prev = _select_scores(B, 3 * pool + 1, 3 * pool + 1,
                                          seed=kc + 1)
                    best = sel.select_keys_plain(sel.rank_keys(
                        prev, torch.arange(3 * pool + 1, device="cuda")),
                        pool)[0].contiguous()
                else:
                    best = torch.empty((B, 0), dtype=torch.int64,
                                       device="cuda")
                args = (S, 7000, valid, 90000, kc, best, pool)
                errs["select"] = max(errs["select"], _select_err(
                    sel.select_chunk(*args), sel.select_chunk_plain(*args),
                    f"B={B} R={R} kc={kc} valid={valid} W0={best.shape[1]}"))
                n += 1
    wide = _select_scores(300, 2200, 2200, seed=3)
    best = sel.select_keys_plain(sel.rank_keys(
        _select_scores(256, 500, 500, seed=4),
        torch.arange(500, device="cuda")), 114)[0].contiguous()
    for S in (wide[:256], wide[:256, 100:2148], wide[:256, 101:2149]):
        args = (S, 0, 2000, 2 ** 32 - 1, 114, best, 114)
        errs["select"] = max(errs["select"], _select_err(
            sel.select_chunk(*args), sel.select_chunk_plain(*args),
            "rows of a wider tensor"))
    for B, W, k in ((256, 228, 114), (37, 7000, 50), (2, 9000, 2100),
                    (2, 9000, 9000), (5, 40000, 700)):
        S = _select_scores(B, W, W, seed=W)
        keys = sel.rank_keys(S, torch.randint(0, 40, (B, W), device="cuda"))
        errs["select"] = max(errs["select"], _select_err(
            sel.select_keys(keys, k), sel.select_keys_plain(keys, k),
            f"keys B={B} W={W} k={k}"))
    torch.cuda.synchronize()
    say(f"[kernels] K: {n} chunk cases (kc 1/16/17/2048 of 2048 lanes, 114 "
        "of 40000, 2500 of 5000, 5000 and 20000 of 20000; valid < R, valid < "
        "kc, an all -inf row, a row of one score; B 1/256; W0 0/pool), 3 "
        "strided, 5 key cases: exact")


def phase_kernels(errs):
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    from metagenome_vector_sketches_tpu_torch.ops import projection as pj

    # P: 2000 sets of 1-5000 hashes (full uint64 range), one of them empty
    rng = np.random.default_rng(1)
    sizes = rng.integers(1, 5001, size=2000)
    sizes[17] = 0
    flat = rng.integers(0, 2**64, size=int(sizes.sum()), dtype=np.uint64)
    check(bool((flat >= 2**63).any()), "no hash >= 2^63 in the P input")
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    h = torch.from_numpy(flat.view(np.int64)).cuda()
    o = torch.from_numpy(offsets).cuda()
    got = pj.project_batch(h, o, D, "cuda")
    want = pj.project_batch_plain(h, o, D)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"projection kernel differs from plain by {err}")
    check(bool((got[17] == 0).all()), "empty set must project to zero")
    errs["projection"] = max(errs["projection"], err)
    say(f"[kernels] P: 2000 sets x d={D}, {len(flat)} hashes: exact")

    cases = [  # (N, d, max_abs, (block, block_j) list)
        (4096, 2048, 1000, [(128, 128), (256, 128)]),
        (2048, 128, 30000, [(128, 128), (256, 128)]),
        (1024, 200, 300, [(128, 128)]),
    ]
    for case, (N, d, max_abs, blocks) in enumerate(cases):
        V, L, planes, thr = _sweep_state(N, d, max_abs, seed=10 + case)
        P = planes.shape[0]
        for block, block_j in blocks:
            for r0, r1 in ((0, None), (1, 3)):
                k = pp.sweep_counts(planes, thr, d, r0, r1, block, block_j)
                p = pp.sweep_counts_plain(planes, thr, d, r0, r1, block,
                                          block_j)
                err = int((k.long() - p.long()).abs().max())
                check(err == 0, f"COUNT differs (N={N} d={d} P={P} "
                                f"blocks {block}/{block_j} rows {r0}:{r1})")
                errs["count"] = max(errs["count"], err)
        # COUNT over a tile list on two operands (the streaming engine's
        # row tile and window), every tile twice
        pi, ti = planes[:, 256:512].contiguous(), thr[256:512].contiguous()
        pj, tj = planes[:, 512:].contiguous(), thr[512:].contiguous()
        win = [(0, j) for j in range((N - 512) // 256)] * 2
        k = pp.count_tiles(pi, ti, pj, tj, pp.TileList(win, "cuda"), 256, d)
        p = pp.count_tiles_plain(pi, ti, pj, tj, win, 256, d)
        err = int((k.long() - p.long()).abs().max())
        check(err == 0, f"COUNT differs on two operands (N={N} d={d})")
        errs["count"] = max(errs["count"], err)
        # APPEND over the triangle grid at tile 256, self-pairs masked (its
        # counts are COUNT's minus the diagonal)
        tile = 256
        nt = N // tile
        coords = np.array([(r, c) for r in range(nt) for c in range(r, nt)],
                          dtype=np.int32)
        cap = 1 << 20
        rc_k, cnt_k, tot_k = pw.sweep_extract(planes, thr, planes, thr,
                                              coords, tile, cap, True, d)
        rc_p, cnt_p, tot_p = pw.sweep_extract_plain(
            planes, thr, planes, thr, coords, tile, cap, True, d)
        n = int(tot_k.item())
        check(n == int(tot_p.item()) and n <= cap, "APPEND totals differ")
        check(torch.equal(cnt_k, cnt_p), "APPEND per-tile counts differ")
        check(np.array_equal(rows_of(rc_k, n), rows_of(rc_p, n)),
              "APPEND survivor sets differ")
        full = pp.sweep_counts(planes, thr, d, block=tile, block_j=tile)
        diag = pw.retention_mask(pw.approx_dot_f32(planes, planes), thr,
                                 thr, d).diagonal().reshape(nt, tile).sum(1)
        ci = torch.from_numpy(coords.astype(np.int64)).cuda()
        want = full[ci[:, 0], ci[:, 1]].long()
        want -= torch.where(ci[:, 0] == ci[:, 1], diag[ci[:, 0]], 0)
        check(torch.equal(cnt_k.long(), want),
              "APPEND counts != COUNT counts minus the diagonal")
        # overflow: a small cap keeps the exact total, writes a subset
        small = max(1, n // 3)
        rc_s, cnt_s, tot_s = pw.sweep_extract(planes, thr, planes, thr,
                                              coords, tile, small, True, d)
        check(int(tot_s.item()) == n and torch.equal(cnt_s, cnt_k),
              "APPEND past its cap must keep counting")
        sub = {tuple(x) for x in rows_of(rc_s, small).tolist()}
        check(len(sub) == small and sub <= {tuple(x) for x in
                                            rows_of(rc_k, n).tolist()},
              "APPEND past its cap wrote pairs that are not survivors")
        # X on the survivors plus some self pairs and random pairs
        extra = torch.from_numpy(rng.integers(0, N, size=(4096, 2))
                                 .astype(np.int32)).cuda()
        cand = torch.cat([rc_k[:n], extra]).contiguous()
        flag = pw.range_flag("cuda")
        xk = pw.pair_partials(planes, cand, L, flag=flag)
        pw.check_range_flag(flag)
        xp = pw.pair_partials_plain(planes, cand, L)
        err = int((xk.long() - xp.long()).abs().max())
        check(err == 0, f"X differs from plain by {err} (L={L})")
        errs["partials"] = max(errs["partials"], err)
        ch = cand.cpu().numpy().astype(np.int64)
        exact = np.einsum("kd,kd->k", V[ch[:, 0]].astype(np.int64),
                          V[ch[:, 1]].astype(np.int64))
        check(np.array_equal(pm.combine_plane_partials(
            xk.cpu().numpy().T, L), exact), "X partials do not combine to "
                                            "the exact dots")
        # X's retention epilogue on the same pairs, both tests, with twins
        # on a shard that starts inside a tile
        # thresholds 0.05 (ns_r + ns_c) about the typical |dot| / d
        ns = rng.uniform(0, 20 * float(np.abs(exact).mean()) / d, N)
        for int16 in (False, True):
            errs["keep"] = max(errs["keep"], _check_keep(
                planes, cand, L, ns, d, int16, N, tile))
        # APPEND on two windows of the db with the self mask at a nonzero
        # diagonal offset (the streaming engine's operands)
        w = N // 2
        for a, b in ((0, N // 4), (N // 2, N // 4)):
            pi, ti = planes[:, a:a + w].contiguous(), thr[a:a + w].contiguous()
            pj, tj = planes[:, b:b + w].contiguous(), thr[b:b + w].contiguous()
            cc = np.array([(r, c) for r in range(w // tile)
                           for c in range(w // tile)], dtype=np.int32)
            rk, ck, tk = pw.sweep_extract(pi, ti, pj, tj, cc, tile, cap, True,
                                          d, b - a)
            rp, cp, tp = pw.sweep_extract_plain(pi, ti, pj, tj, cc, tile,
                                                cap, True, d, b - a)
            m = int(tk.item())
            check(m == int(tp.item()) and torch.equal(ck, cp)
                  and np.array_equal(rows_of(rk, m), rows_of(rp, m)),
                  f"APPEND with diag_offset {b - a} differs from plain")
            got = rows_of(rk, m)
            check(not bool((got[:, 0] + a == got[:, 1] + b).any()),
                  f"APPEND with diag_offset {b - a} kept a self-pair")
        say(f"[kernels] S/X: N={N} d={d} L={L} P={P}: COUNT exact, APPEND "
            f"{n} survivors exact (also at diag_offset {N // 4}, "
            f"{-N // 4}), X {len(ch)} pairs exact")

    _core_cases(errs)
    _select_cases(errs)

    # G: ragged n, u and row ranges (zero padded)
    for n, u, b, e in ((1, 1, 0, 1), (130, 100, 0, 130),
                       (1000, 5000, 128, 300), (2000, 16384, 5, 1999),
                       (128, 64, 0, 128), (384, 64, 200, 384)):
        err = _gram_rows_err(_incidence(n, u, 0.05, n), b, e)
        check(err == 0, f"kernel G differs from plain by {err} (n={n}, "
                        f"u={u}, rows {b}..{e})")
        errs["gram"] = max(errs["gram"], err)
    say("[kernels] G: n x u (rows) = 1x1 (0..1), 130x100 (0..130), 1000x5000 "
        "(128..300), 2000x16384 (5..1999), 128x64 (0..128), 384x64 "
        "(200..384): exact")


# ---------------------------------------------------------------------------
# phase 2: the main path at production size
# ---------------------------------------------------------------------------

def _check_projection(flat, sizes, what):
    """Kernel P on one CSR batch (offsets on the host, as project_many
    passes them) equal to the plain version."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import projection as pj
    h = torch.from_numpy(flat).cuda()
    o = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    check(torch.equal(pj.project_batch(h, o, D, "cuda"),
                      pj.project_batch_plain(h, torch.from_numpy(o).cuda(),
                                             D)),
          f"projection differs from plain at the {what} batch")


def _check_partials(x, rc, L, y=None):
    """Kernel X on candidate pairs: equal to the plain version, range flag
    clear."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    flag = pw.range_flag("cuda")
    check(torch.equal(pw.pair_partials(x, rc, L, y, flag),
                      pw.pair_partials_plain(x, rc, L, y)),
          f"partials differ from plain ({len(rc)} pairs)")
    pw.check_range_flag(flag)


def _check_keep(planes, rc, L, ns, d, int16, total, tile):
    """Kernel X's retention epilogue against its plain version on the card
    (a shard of rows [total / 5, 3 total / 5), twins on ``tile``): the
    same kept set and counters, the first buffer a third of the kept
    count and then the exact size -> 0 (the error; raises otherwise)."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    keep = pw.Retention(torch.from_numpy(ns).cuda(), d, int16, total // 5,
                        3 * total // 5, total)
    b, e = keep.begin_row // tile, (keep.end_row - 1) // tile + 1
    twins = (tile, b, e)
    out_p, cnt_p = pw.pair_keep_plain(planes, rc, L, keep, len(rc) * 2,
                                      twins=twins)
    want = cnt_p.cpu().numpy()
    small = max(1, int(want[0]) // 3)
    out_k, cnt_k = pw.pair_keep(planes, rc, L, keep, small, twins=twins)
    check(np.array_equal(cnt_k.cpu().numpy(), want),
          f"keep counters {cnt_k.tolist()} != plain {want.tolist()}")
    out_k, cnt_k = pw.pair_keep(planes, rc, L, keep, int(want[0]),
                                twins=twins)

    def records(out):       # the kept pairs as a multiset: rc may repeat
        a = out[:int(want[0])].cpu().numpy()
        return a[np.lexsort((a[:, 1], a[:, 0]))]
    check(np.array_equal(records(out_k), records(out_p)),
          f"keep's kept pairs differ from plain (int16={int16})")
    say(f"[kernels] X keep int16={int16}: {len(rc)} pairs, {want[0]} kept, "
        f"{want[1]} emitted: exact (first buffer {small}, then exact)")
    return 0


def phase_main(N, work):
    import torch
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.bench_data import (
        GROUP, csr_hashes, skewed_set_sizes, spot_check, synth_hashes_file)
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)
    from metagenome_vector_sketches_tpu_torch.io.ingest import sketch
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.ops import projection as pj
    from metagenome_vector_sketches_tpu_torch.query import (
        engine as query_engine)

    n_groups, n_heavy = max(1, N // 64), max(1, N // 128)
    hashes = os.path.join(work, "all_hashes.txt")
    synth_hashes_file(hashes, N, n_groups, n_heavy)
    db_path, mat = os.path.join(work, "db"), os.path.join(work, "mat")

    _build.reset_launch_counts()
    db = sketch(hashes, db_path, D, device="cuda", verbose=False)
    mc.compute_pairwise_shard(db_path, mat, device="cuda", verbose=False)
    names, norms = db.names_and_norms_f32()
    rng = np.random.default_rng(3)
    n_query = min(1024, n_groups * GROUP)
    qrows = sorted(int(r) for r in rng.choice(n_groups * GROUP, n_query,
                                              replace=False))
    results = query_engine.query(mat, qrows, norms, names)
    launches = _build.launch_counts()
    say(f"[main] N={N} d={D}: sketch, one shard ({mc.LAST_STAGES['mode']}, "
        f"{mc.LAST_STAGES['pairs_written']} pairs), {n_query} queries; "
        f"launches {launches}")
    found = 0
    for row, res in zip(qrows, results):
        g = row // GROUP
        mates = {f"ACC{g * GROUP + m:07d}" for m in range(GROUP)} \
            - {f"ACC{row:07d}"}
        found += len(mates & set(res.neighbor_ids))
    recall = found / (3 * n_query)
    say(f"[main] planted recall {recall}")
    check(recall == 1.0, f"planted recall {recall} != 1.0")
    check(pm.pick_limbs(max(1, db.max_component())) == 2,
          "the main path must run the 2-limb (P=3) planes")
    check(bool(spot_check(db_path, mat, N, D, n_rows=3)),
          "oracle spot check failed")
    say("[main] oracle spot check on 3 rows: ok")
    for k in MAIN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the main "
                               "path")

    # kernels against their plain versions at the main path's shapes
    named = parse_hashes_file(hashes)[:pj.BATCH_SETS]  # project_many's batch
    sizes = np.array([len(h) for _, h in named])
    _check_projection(np.concatenate([x for _, x in named]).view(np.int64),
                      sizes, "main")
    skew = skewed_set_sizes()
    _check_projection(csr_hashes(skew, seed=3), skew, "skewed")

    tile = 2048
    V = np.fromfile(os.path.join(db_path, "vectors.bin"), dtype=np.int32,
                    count=4 * tile * D).reshape(4 * tile, D)
    L = pm.pick_limbs(max(1, db.max_component()))
    planes = torch.zeros((pm.num_planes(L), 4 * tile, pw.pad_dim(D)),
                         dtype=torch.int8, device="cuda")
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V).cuda(),
                                                L), 0)
    _, norms64 = db.names_and_norms()
    thr = _row_thresholds(planes, norms64[:4 * tile] ** 2, L, D)
    coords = np.array([(r, c) for r in range(4) for c in range(r, 4)],
                      dtype=np.int32)
    tiles = pw.TileList(coords, "cuda")       # the engine's list on the card
    cap = 1 << 22
    rc_k, cnt_k, tot_k = pw.sweep_extract(planes, thr, planes, thr, tiles,
                                          tile, cap, True, D)
    rc_p, cnt_p, tot_p = pw.sweep_extract_plain(planes, thr, planes, thr,
                                                coords, tile, cap, True, D)
    n = int(tot_k.item())
    check(n == int(tot_p.item()) and torch.equal(cnt_k, cnt_p)
          and np.array_equal(rows_of(rc_k, n), rows_of(rc_p, n)),
          "APPEND differs from plain at main-path shapes")
    self_rc = torch.arange(4 * tile, dtype=torch.int32, device="cuda")
    cand = torch.cat([rc_k[:n], self_rc[:, None].expand(-1, 2)]).contiguous()
    _check_partials(planes, cand, L)
    _check_keep(planes, cand, L, norms64[:4 * tile] ** 2, D, False,
                4 * tile, tile)
    say(f"[main] P on {len(named)} sets ({int(sizes.sum())} hashes) and the "
        f"skewed batch ({len(skew)} sets, {int(skew.sum())} hashes); APPEND "
        f"on {len(coords)} tiles of {tile}^2 (P={planes.shape[0]}, {n} "
        f"survivors); X on {len(cand)} pairs at L={L}: exact")
    # the shard's planes stay in the residency slot: free them for the
    # phases that follow
    mc.clear_device_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3: the README walkthrough through the port's command-line tools
# ---------------------------------------------------------------------------

def _oracle(db_path, dtype):
    """Exact retained (row, col) -> quantised Jaccard of a db folder."""
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix.writer import (
        quantize_jaccard)
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    db = DbFolder(db_path)
    V = db.load_vectors().astype(np.float64)
    _, norms = db.names_and_norms()
    ns = norms * norms
    dots = (V @ V.T).astype(np.int64)           # exact: |dot| < 2^53
    r, c = np.nonzero(np.ones_like(dots, dtype=bool))
    dv = dots.reshape(-1)
    filt = pm.exact_filter_int16 if dtype == "int16" else pm.exact_filter_int32
    keep = filt(dv, 0.05 * (ns[r] + ns[c]), V.shape[1])
    r, c, dv = r[keep], c[keep], dv[keep]
    q = quantize_jaccard(dv, r, c, ns, V.shape[1])
    return {(int(a), int(b)): int(x) for a, b, x in zip(r, c, q)}


def _minhash_triples_oracle(sizes, r, c, inter):
    """{(row, col): quantised set Jaccard} of the pairs the MinHash shard
    retains (intersection > 0.05 (|A| + |B|), float64) among the given
    exact intersections."""
    from metagenome_vector_sketches_tpu_torch.matrix.writer import (
        quantize_jaccard)
    keep = inter.astype(np.float64) > 0.05 * (sizes[r] + sizes[c])
    r, c, inter = r[keep], c[keep], inter[keep]
    q = quantize_jaccard(inter, r, c, sizes.astype(np.float64), 1)
    return {(int(a), int(b)): int(x) for a, b, x in zip(r, c, q)}


def _minhash_oracle(sets):
    """The MinHash shard's exact triples from a scipy sparse incidence
    product (independent of the port's dense incidence and kernel G)."""
    import scipy.sparse as sp
    uniq = [np.unique(np.asarray(x, dtype=np.uint64)) for x in sets]
    sizes = np.array([len(u) for u in uniq], dtype=np.int64)
    flat = np.concatenate(uniq)
    universe, cols = np.unique(flat, return_inverse=True)
    rows = np.repeat(np.arange(len(uniq)), sizes)
    M = sp.csr_matrix((np.ones(len(flat), dtype=np.int64),
                       (rows, cols.ravel())),
                      shape=(len(uniq), len(universe)))
    G = (M @ M.T).tocoo()
    return _minhash_triples_oracle(sizes, G.row.astype(np.int64),
                                   G.col.astype(np.int64),
                                   G.data.astype(np.int64))


def _triples(mat, n):
    from metagenome_vector_sketches_tpu_torch.matrix.reader import (
        MatrixReader)
    r, c, q = MatrixReader(mat).decode_all_triples(n)
    return {(int(a), int(b)): int(x) for a, b, x in zip(r, c, q)}


def _same_shards(a, b, n_shards, what):
    import filecmp
    for s in range(n_shards):
        for f in SHARD_FILES:
            check(filecmp.cmp(os.path.join(a, f"shard_{s}", f),
                              os.path.join(b, f"shard_{s}", f),
                              shallow=False), f"{what}: shard_{s}/{f} differs")


def _jaccard_oracle(db_path, qrows, j):
    """{(query position, neighbour name): exact-form Jaccard} for the db's
    own rows qrows as queries, from float64-exact cosines; every pair
    above j - 1e-5 (the band the f32 engine's ips may straddle)."""
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    db = DbFolder(db_path)
    V = db.load_vectors().astype(np.int64)
    names, norms = db.names_and_norms()
    d = V.shape[1]
    ns = np.einsum("ij,ij->i", V, V)
    ip = (V[qrows] @ V.T) / np.sqrt(ns[None, :].astype(np.float64)
                                    * ns[qrows, None].astype(np.float64))
    qn = np.linalg.norm((V[qrows].astype(np.float64) / np.sqrt(d))
                        .astype(np.float32), axis=1).astype(np.float64)
    jac = ip * qn[:, None] * norms[None, :] / (
        norms[None, :] ** 2 + qn[:, None] ** 2
        - ip * qn[:, None] * norms[None, :])
    q, c = np.nonzero(jac > j - 1e-5)
    return {(int(a), names[b]): float(jac[a, b]) for a, b in zip(q, c)}


def _held(got, want, j, band, tol, what):
    """got {(q, name): jaccard} against the oracle: the same pairs apart
    from oracle pairs within band of j, each Jaccard within tol."""
    sure = {p for p, x in want.items() if x > j + band}
    check(sure <= set(got) <= set(want),
          f"{what}: neighbours differ from the oracle "
          f"({len(sure - set(got))} missing, {len(set(got) - set(want))} "
          "extra)")
    bad = [p for p, x in got.items() if abs(x - want[p]) > tol]
    check(not bad, f"{what}: Jaccard off the oracle at {bad[:3]}")


def _jaccard_walkthrough(work, db_path, hashes, qrows, dtype):
    """README step 5 through the port's jaccard tool: index, search with the
    f32 and int8 engines, test — each held against the numpy oracle."""
    import contextlib
    import io
    import re
    from metagenome_vector_sketches_tpu_torch.cli import jaccard
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(jaccard.main(argv) == 0, f"jaccard {argv[0]} CLI")
        return buf.getvalue().splitlines()

    names, _ = DbFolder(db_path).names_and_norms()
    with open(hashes) as f:
        lines = {ln.split(":", 1)[0]: ln for ln in f}
    qfile = os.path.join(work, "q_hashes.txt")
    with open(qfile, "w") as f:
        f.writelines(lines[names[i]] for i in qrows)
    run(["index", db_path])
    j = 0.1
    want = _jaccard_oracle(db_path, qrows, j)
    for engine, band in (("f32", 1e-5), ("int8", 1e-9)):
        got, q = {}, None
        for ln in run(["search", db_path, qfile, "-j", str(j), "--engine",
                       engine]):
            m = re.match(r"Query (\d+):$", ln)
            if m:
                q = int(m.group(1))
            m = re.match(r"  Neighbor \d+: (\S+) \(jaccard: ([0-9.]+)\)", ln)
            if m:
                got[(q, m.group(1))] = float(m.group(2))
        # the printed Jaccard has 4 decimals
        _held(got, want, j, band, 5e-5 + band,
              f"jaccard search {engine} ({dtype})")
    sets = {n: set(h.tolist()) for n, h in parse_hashes_file(hashes)}
    out = run(["test", db_path, hashes, "-n", "8", "--seed", "1", "-j",
               str(j)])
    pat = re.compile(r"(\S+) vs (\S+): vector_jaccard=([0-9.]+), "
                     r"hash_jaccard=([0-9.]+)$")
    pairs = [m.groups() for m in map(pat.match, out) if m]
    qids = sorted({a for a, _, _, _ in pairs})
    check(len(qids) == 8, f"jaccard test sampled {len(qids)} of 8 queries")
    rows = [names.index(a) for a in qids]
    tw = {(qids[q], n): x for (q, n), x in
          _jaccard_oracle(db_path, rows, j).items()}
    _held({(a, b): float(x) for a, b, x, _ in pairs}, tw, j, 1e-5,
          5e-5 + 1e-5, f"jaccard test ({dtype})")
    for a, b, _, h in pairs:
        s1, s2 = sets[a], sets[b]
        check(h == f"{len(s1 & s2) / len(s1 | s2):.4f}",
              f"jaccard test: hash Jaccard of {a} vs {b}")
    say(f"[cli] {dtype}: jaccard index -> search (f32, int8) -> test equal "
        f"the exact oracle ({len(want)} neighbours of {len(qrows)} queries,"
        f" {len(pairs)} tested pairs)")


def _cli_flags_and_minhash(work, db_path, hashes, mat, N):
    """pairwise_comp --finalize device / --gate_sparse_tiles write the
    default run's bytes; --strategy 1 equals the exact set-Jaccard
    oracle."""
    from metagenome_vector_sketches_tpu_torch.cli import pairwise_comp
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)
    base = ["--db", db_path, "--max_memory_gb", "4", "--num_threads", "1"]
    for flags in (["--finalize", "device"], ["--gate_sparse_tiles"]):
        alt = os.path.join(work, "cli_mat" + flags[0].replace("-", "_"))
        for s in range(2):
            check(pairwise_comp.main(
                base + ["--output_folder", alt, "--num_shards", "2",
                        "--shard_idx", str(s), *flags]) == 0,
                f"pairwise_comp {' '.join(flags)}")
        _same_shards(mat, alt, 2, f"pairwise_comp {' '.join(flags)}")
    mh = os.path.join(work, "cli_minhash")
    check(pairwise_comp.main(
        base + ["--output_folder", mh, "--num_shards", "1", "--shard_idx",
                "0", "--strategy", "1", "--hashes", hashes]) == 0,
        "pairwise_comp --strategy 1")
    names, _ = DbFolder(db_path).names_and_norms()
    sets = dict(parse_hashes_file(hashes))
    want = _minhash_oracle([sets[n] for n in names])
    check(_triples(mh, N) == want,
          "pairwise_comp --strategy 1 differs from the set-Jaccard oracle")
    say(f"[cli] int32: --finalize device and --gate_sparse_tiles shards equal "
        f"the default run's; --strategy 1 equals the exact set-Jaccard oracle "
        f"({len(want)} pairs)")


def phase_cli(work):
    from metagenome_vector_sketches_tpu_torch.bench_data import (
        synth_hashes_file)
    from metagenome_vector_sketches_tpu_torch.cli import (
        pairwise_comp, project_everything, query_pc_mat)
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix.reader import (
        MatrixReader)
    N = 2048
    hashes = os.path.join(work, "cli_hashes.txt")
    synth_hashes_file(hashes, N, N // 64, N // 128, seed=11)
    for dtype in ("int32", "int16"):
        db_path = os.path.join(work, f"cli_db_{dtype}")
        mat = os.path.join(work, f"cli_mat_{dtype}")
        check(project_everything.main(
            ["sketch", hashes, db_path, "-d", str(D)]
            + (["--int16"] if dtype == "int16" else [])) == 0, "sketch CLI")
        for s in range(2):
            check(pairwise_comp.main(
                ["--db", db_path, "--max_memory_gb", "4", "--num_threads",
                 "1", "--output_folder", mat, "--num_shards", "2",
                 "--shard_idx", str(s)]) == 0, "pairwise_comp CLI")
        want = _oracle(db_path, dtype)
        r, c, q = MatrixReader(mat).decode_all_triples(N)
        got = {(int(a), int(b)): int(x) for a, b, x in zip(r, c, q)}
        check(got == want, f"{dtype} shards differ from the exact oracle")
        if dtype == "int32":
            _cli_flags_and_minhash(work, db_path, hashes, mat, N)
        names, _ = DbFolder(db_path).names_and_norms()
        qfile = os.path.join(work, "q.txt")
        qrows = list(range(0, 64, 3))
        with open(qfile, "w") as f:
            f.write("\n".join(names[i] for i in qrows) + "\n")
        out = os.path.join(work, f"top_{dtype}.csv")
        check(query_pc_mat.main(["--matrix", mat, "--db", db_path,
                                 "--query_file", qfile, "--top", "5",
                                 "--write_to_file", out]) == 0, "query CLI")
        for i in qrows:
            nb = sorted(((cc, qq) for (rr, cc), qq in want.items() if rr == i),
                        key=lambda t: (-t[1], t[0]))[:5]
            expect = ["ID,Jaccard"] + [
                f"{names[cc]},{float(np.float32(qq / 255.0)):.6g}"
                for cc, qq in nb]
            with open(os.path.join(work, f"{names[i]}_top_{dtype}.csv")) as f:
                check(f.read().splitlines() == expect,
                      f"top-5 of {names[i]} ({dtype}) differs from oracle")
        rows, cols = list(range(0, 40, 2)), list(range(0, 64))
        for fname, ids in (("rows.txt", rows), ("cols.txt", cols)):
            with open(os.path.join(work, fname), "w") as f:
                f.write("\n".join(names[i] for i in ids) + "\n")
        sliced = os.path.join(work, f"sliced_{dtype}.csv")
        check(query_pc_mat.main(
            ["--matrix", mat, "--db", db_path, "--row_file",
             os.path.join(work, "rows.txt"), "--col_file",
             os.path.join(work, "cols.txt"), "--write_to_file", sliced]) == 0,
            "sliced query CLI")
        with open(sliced) as f:
            lines = f.read().splitlines()
        check(lines[0] == "Accession," + ",".join(names[i] for i in cols)
              + ",", "sliced header")
        for line, i in zip(lines[1:], rows):
            vals = [f"{float(np.float32(want.get((i, j), 0) / 255.0)):.6g}"
                    for j in cols]
            check(line == names[i] + "," + ",".join(vals) + ",",
                  f"sliced row {names[i]} ({dtype}) differs from oracle")
        say(f"[cli] {dtype}: sketch -> pairwise_comp x2 shards -> top-5 and "
            f"sliced queries equal the exact oracle ({len(want)} pairs)")
        _jaccard_walkthrough(work, db_path, hashes, qrows, dtype)


# ---------------------------------------------------------------------------
# phase 7: the query, legacy and analysis tools, the toy fixture's
# conformance, the residency cache and the device trace
# ---------------------------------------------------------------------------

TOOLS_KERNELS = ("projection", "sweep", "keep")


def _stdout_of(main, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"{main.__module__} {' '.join(argv[:2])} exit code {rc}")
    return buf.getvalue().splitlines()


def _tools_queries(work, want, names, N):
    """read_pc_mat and the port's read_pc_mat_module on phase 3's card-made
    int32 db and its two shards: every neighbour and Jaccard equals the
    exact oracle and phase 3's query_pc_mat top-5 files."""
    from metagenome_vector_sketches_tpu_torch import read_pc_mat_module as rpc
    from metagenome_vector_sketches_tpu_torch.cli import read_pc_mat
    db_path = os.path.join(work, "cli_db_int32")
    mat = os.path.join(work, "cli_mat_int32")
    qrows = list(range(0, 64, 3))
    rows, cols = list(range(0, 40, 2)), list(range(64))
    files = {}
    for fname, ids in (("q", qrows), ("rows", rows), ("cols", cols)):
        files[fname] = os.path.join(work, f"tools_{fname}.txt")
        with open(files[fname], "w") as f:
            f.write("\n".join(names[i] for i in ids) + "\n")

    def oracle_row(i):
        nb = sorted(((c, q) for (r, c), q in want.items() if r == i),
                    key=lambda t: (-t[1], t[0]))
        return ([names[c] for c, _ in nb],
                np.array([np.float32(q / 255.0) for _, q in nb],
                         dtype=np.float32))

    res = rpc.query(mat, db_path, files["q"])
    check(len(res) == len(qrows), "read_pc_mat_module.query: result count")
    expect = []
    for i, r in zip(qrows, res):
        ids, jac = oracle_row(i)
        check(r["id"] == names[i] and list(r["neighbor_ids"]) == ids
              and np.array_equal(r["jaccard_similarities"], jac),
              f"read_pc_mat_module.query of {names[i]} differs from oracle")
        with open(os.path.join(work, f"{names[i]}_top_int32.csv")) as f:
            top = f.read().splitlines()[1:]
        check(top == [f"{a},{float(x):.6g}" for a, x in zip(ids[:5], jac)],
              f"query_pc_mat's top-5 of {names[i]} differs from "
              "read_pc_mat_module.query")
        n = min(10, len(ids))
        expect += [f"Query {names[i]}: #Neighbors = {len(ids)}",
                   f"Top {n} neighbors:",
                   f"Neighbor IDs: {np.array(ids)[:n]}",
                   f"Jaccard Similarities: {jac[:n]}", ""]
    out = _stdout_of(read_pc_mat.main, ["--matrix", mat, "--db", db_path,
                                        "--query_file", files["q"]])
    check(out[0].startswith("Processing query_file")
          and out[1].startswith("Query completed in") and out[2] == ""
          and "\n".join(out[3:]) == "\n".join(expect),
          "read_pc_mat --query_file differs from the exact oracle")
    sl = rpc.query_sliced(mat, db_path, files["rows"], files["cols"])
    check(sl["row-list"] == [names[i] for i in rows]
          and sl["col-list"] == [names[j] for j in cols],
          "read_pc_mat_module.query_sliced: row and column ids")
    for i in rows:
        check(sl["jac-dict"][names[i]] == [
            float(np.float32(want.get((i, j), 0) / 255.0)) for j in cols],
            f"read_pc_mat_module.query_sliced row {names[i]} differs from "
            "oracle")
    say(f"[tools] read_pc_mat --query_file and read_pc_mat_module.query "
        f"({len(qrows)} queries) and query_sliced ({len(rows)} x "
        f"{len(cols)}) equal the exact oracle and query_pc_mat's top-5")
    return qrows


def _tools_legacy(work, want, names, qrows, N):
    """The card-made shards' decoded triples through the legacy format A
    (quantised Jaccards as the values, dimension 1) and query_ava_matrix,
    plain and zstd-compressed; export_npz of the shards."""
    from metagenome_vector_sketches_tpu_torch.analysis.export import (
        export_npz)
    from metagenome_vector_sketches_tpu_torch.cli import query_ava_matrix
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import legacy
    from metagenome_vector_sketches_tpu_torch.matrix.reader import (
        MatrixReader)
    from metagenome_vector_sketches_tpu_torch.utils import zstdio
    db_path = os.path.join(work, "cli_db_int32")
    mat = os.path.join(work, "cli_mat_int32")
    r, c, q = MatrixReader(mat).decode_all_triples(N)
    npz = np.load(export_npz(mat, N, os.path.join(work, "tools_coo.npz")))
    check({(int(a), int(b)): int(x) for a, b, x in zip(
        npz["row"], npz["col"], npz["data"])} == want
        and len(npz["row"]) == len(r),
        "export_npz differs from decode_all_triples and the oracle")
    leg = os.path.join(work, "tools_legacy")
    legacy.write_legacy_prev(leg, r, c, q, 1)
    back = legacy.read_legacy_prev(leg)
    check({(row, int(cc)): int(v) for row, (cs, vs) in back.items()
           for cc, v in zip(cs, vs)} == want,
          "legacy format A round trip differs from the oracle")
    _, norms = DbFolder(db_path).names_and_norms_f32()
    ids = qrows[:8]
    expect = [f"Total vectors loaded: {N}"]
    for i in ids:
        expect.append(f"Query: {i} ({names[i]})")
        cs = sorted(cc for rr, cc in want if rr == i)
        vals = [want[(i, cc)] for cc in cs]
        na = float(norms[i]) ** 2
        jac = np.array([v / (na + float(norms[cc]) ** 2 - v)
                        for cc, v in zip(cs, vals)])
        for k in np.argsort(-jac, kind="stable")[:5]:
            expect.append(f"  {cs[k]} ({names[cs[k]]}) intersection="
                          f"{vals[k]} jaccard={jac[k]:.6g}")
        expect.append("")
    argv = ["--matrix", leg, "--db", db_path, "--query_ids",
            *map(str, ids), "--top", "5"]
    check(_stdout_of(query_ava_matrix.main, argv) == expect,
          "query_ava_matrix differs from the exact oracle")
    zst = "not available: skipped"
    if zstdio.available():
        legacy.compress_legacy_folder(leg)
        check(all(f.endswith(".zst") for f in os.listdir(leg))
              and _stdout_of(query_ava_matrix.main, argv) == expect,
              "query_ava_matrix on the .zst folder differs")
        zst = f"{zstdio._get_backend()[0]}: the .zst folder reads the same"
    say(f"[tools] export_npz and legacy format A hold the oracle's "
        f"{len(want)} triples; query_ava_matrix ({len(ids)} queries) equals "
        f"the exact oracle; zstd {zst}")


def _tools_toy(work):
    """The toy fixture on the card: sketch --device device writes its
    vectors.bin; one shard, inside device_trace, equals
    compute_pairwise_oracle, and the trace names kernels APPEND and X."""
    import filecmp
    import re
    from metagenome_vector_sketches_tpu_torch.cli import project_everything
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.matrix.reader import (
        MatrixReader)
    from metagenome_vector_sketches_tpu_torch.matrix.writer import (
        quantize_jaccard)
    from metagenome_vector_sketches_tpu_torch.utils.profiling import (
        device_trace)
    toy = os.path.join(ROOT, "tests", "fixtures", "ref_toy")
    toy_db = os.path.join(toy, "toy_db_256")
    out_db = os.path.join(work, "tools_toy_db")
    check(project_everything.main(
        ["sketch", os.path.join(toy, "all_hashes_toy.txt"), out_db, "-d",
         "256", "--device", "device"]) == 0, "sketch --device device")
    check(filecmp.cmp(os.path.join(toy_db, "vectors.bin"),
                      os.path.join(out_db, "vectors.bin"), shallow=False),
          "sketch --device device differs from toy_db_256/vectors.bin")
    trace_dir = os.path.join(work, "tools_trace")
    mat = os.path.join(work, "tools_toy_mat")
    with device_trace(trace_dir):
        mc.compute_pairwise_shard(toy_db, mat, device="cuda", verbose=False)
    db = DbFolder(toy_db)
    V = db.load_vectors().astype(np.int32)
    _, norms = db.names_and_norms()
    ns = norms * norms
    r, c, v = mc.compute_pairwise_oracle(V, ns, db.dimension, db.dtype)
    q = quantize_jaccard(v, r, c, ns, db.dimension)
    want = set(zip(r.tolist(), c.tolist(), q.tolist()))
    rr, cc, qq = MatrixReader(mat).decode_all_triples(len(V))
    check(set(zip(rr.tolist(), cc.tolist(), qq.tolist())) == want,
          "toy_db_256 shard differs from compute_pairwise_oracle")
    traces = os.listdir(trace_dir)
    check(len(traces) == 1, f"device_trace wrote {traces}")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e.get("name", "") for e in events
                      if e.get("cat") == "kernel"})
    mine = {m.group(0) for k in kernels for m in [re.search(
        r"(retention_kernel|partials_kernel|project_\w+)(<[^>]*>)?", k)]
            if m}
    say(f"[tools] device_trace kernels of the port: "
        f"{json.dumps(sorted(mine))}; {len(kernels)} kernel names in all")
    for name in ("retention_kernel", "partials_kernel"):
        check(any(name in k for k in kernels), f"the trace names no {name}")
    say(f"[tools] toy_db_256: sketch --device device writes its vectors.bin;"
        f" its shard on the card equals compute_pairwise_oracle ({len(want)} "
        f"triples); the trace ({os.path.getsize(os.path.join(trace_dir, traces[0]))}"
        " B) names retention_kernel and partials_kernel")


def _tools_cache(work, N):
    """Shards 0 and 1 of 2 of phase 2's db in one process: the second
    re-uses the staged planes; after clear_device_cache a fresh shard 1 is
    byte-equal."""
    import filecmp
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    db_path = os.path.join(work, "db")
    stages = []
    for s in (0, 1):
        mc.compute_pairwise_shard(db_path, os.path.join(work, "cache_mat"),
                                  num_shards=2, shard_idx=s, device="cuda",
                                  verbose=False)
        stages.append(dict(mc.LAST_STAGES))
    check(all(st["mode"] == "fused" for st in stages),
          "the cache check's shards must run resident")
    stage_ms = [st["stage_ms"] for st in stages]
    say(f"[tools] residency cache N={N}: shard 1 of 2's stage_ms "
        f"{100 * stage_ms[1] / stage_ms[0]:.2f}% of shard 0's")
    check(stage_ms[1] < 0.05 * stage_ms[0],
          "the second shard's stage_ms is not under 5% of the first's")
    mc.clear_device_cache()
    mc.compute_pairwise_shard(db_path, os.path.join(work, "cache_fresh"),
                              num_shards=2, shard_idx=1, device="cuda",
                              verbose=False)
    for f in SHARD_FILES:
        check(filecmp.cmp(os.path.join(work, "cache_mat", "shard_1", f),
                          os.path.join(work, "cache_fresh", "shard_1", f),
                          shallow=False),
              f"shard_1/{f} from the slot differs from a fresh staging")
    say("[tools] shard 1 from the slot is byte-equal to shard 1 after "
        "clear_device_cache()")


def phase_tools(N, work):
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    n_cli = 2048
    want = _oracle(os.path.join(work, "cli_db_int32"), "int32")
    names, _ = DbFolder(os.path.join(work, "cli_db_int32")).names_and_norms()
    _build.reset_launch_counts()
    qrows = _tools_queries(work, want, names, n_cli)
    _tools_legacy(work, want, names, qrows, n_cli)
    _tools_toy(work)
    _tools_cache(work, N)
    launches = _build.launch_counts()
    mc.clear_device_cache()
    say(f"[tools] launches {launches}")
    for k in TOOLS_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the tools "
                               "phase")
    return launches


# ---------------------------------------------------------------------------
# phase 4: ANN serving at the JAX package's ANN-at-scale size
# ---------------------------------------------------------------------------

ANN_CHUNK = 262144      # IntExactIndex's default chunk_rows
ANN_B, ANN_K = 256, 50  # benchmarks/ann_scale.py's batch and k
ANN_GROUP_STRIDE = 256  # a planted group of 4 starts every 256 rows


def _ann_chunks(N, seed=5):
    """[(base, (rows, D) int32)] sketch-like vectors on the card: rounded
    normals of sd 150 clipped to +-600 (L = 2, P = 3), rows 1-3 of every
    256 near-duplicates (+-3) of row 0."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    chunks = []
    for s in range(0, N, ANN_CHUNK):
        rows = min(ANN_CHUNK, N - s)
        v = (torch.randn((rows, D), generator=g, device="cuda") * 150) \
            .round_().clamp_(-600, 600).to(torch.int32)
        grp = v[:rows // ANN_GROUP_STRIDE * ANN_GROUP_STRIDE].view(
            -1, ANN_GROUP_STRIDE, D)
        noise = torch.randint(-3, 4, (grp.shape[0], 3, D), generator=g,
                              device="cuda", dtype=torch.int32)
        grp[:, 1:4] = (grp[:, :1] + noise).clamp_(-600, 600)
        chunks.append((s, v))
    return chunks


def _brute_force(chunks, Q, k):
    """float64-exact cosines of the int32 queries Q (B, D) numpy against
    every row, on the card -> (scores (B, k) float64, rows (B, k)): score
    desc, then lowest row — the int8 engine's own math and order."""
    import torch
    q = torch.from_numpy(Q).cuda()
    qd = q.double()
    qns = (q.long() ** 2).sum(1).double()
    parts = []
    for _, v in chunks:
        dots = qd @ v.double().T                     # exact: < 2^53
        ns = (v.long() ** 2).sum(1).double()
        denom = torch.sqrt(ns[None, :] * qns[:, None])
        parts.append(torch.where(denom > 0,
                                 dots / torch.clamp(denom, min=1e-300),
                                 torch.zeros_like(dots)))
    score = torch.cat(parts, dim=1)
    s, i = torch.sort(score, dim=1, descending=True, stable=True)
    return s[:, :k + 1].cpu().numpy(), i[:, :k + 1].cpu().numpy()


def phase_ann(N, errs):
    import torch
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ann import int_index as ii
    from metagenome_vector_sketches_tpu_torch.ann import search as asearch
    from metagenome_vector_sketches_tpu_torch.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw

    chunks = _ann_chunks(N)
    flat_chunks = []
    for s, v in chunks:
        x = v.float()
        flat_chunks.append((s, x / x.norm(dim=1, keepdim=True).clamp_(
            min=1e-30)))
        del x
    index = ii.IntExactIndex.from_device_chunks(list(chunks), D)
    flat = FlatIPIndex.from_device_chunks(flat_chunks, D)
    torch.cuda.synchronize()
    check(index.L == 2 and index._stack.shape[1] == 3,
          "the ANN index must run the 2-limb (P=3) planes")
    say(f"[ann] built IntExactIndex ({tuple(index._stack.shape)} int8) and "
        f"FlatIPIndex from {N} x {D} int32 vectors made on the card")

    rng = np.random.default_rng(9)
    n_groups = N // ANN_GROUP_STRIDE
    groups = np.sort(rng.choice(n_groups, ANN_B, replace=False))
    qrows = groups * ANN_GROUP_STRIDE
    V_q = torch.cat([chunks[r // ANN_CHUNK][1][r % ANN_CHUNK][None]
                     for r in qrows.tolist()]).cpu().numpy()
    Qf = V_q.astype(np.float64) / np.sqrt(D)
    Qn = normalize_l2(V_q.astype(np.float32))
    ns = index.ns
    norms = np.sqrt(ns.astype(np.float64) / D)

    # the counted run of the ANN path: two searches, two adaptive searches
    _build.reset_launch_counts()
    Di, Ii = index.search(V_q, ANN_K)
    Df, If = flat.search(Qn, ANN_K)
    adaptive = {}
    for name, idx, qi in (("int8", index, V_q), ("f32", flat, None)):
        hits, qn = asearch.adaptive_search(idx, Qf, 0.1, verbose=False,
                                           db_norms=norms, queries_int=qi)
        adaptive[name] = (hits, dict(asearch.LAST_ADAPTIVE_STAGES))
    launches = _build.launch_counts()
    for k in ANN_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the ANN path")
    say(f"[ann] N={N} d={D} B={ANN_B} k={ANN_K}: launches {launches}")

    for name, I in (("int8", Ii), ("f32", If)):
        found = sum(len({int(r) + m for m in range(4)} & set(I[b].tolist()))
                    for b, r in enumerate(qrows))
        recall = found / (4 * ANN_B)
        say(f"[ann] {name} planted recall {recall}")
        check(recall == 1.0, f"{name} planted recall {recall} != 1.0")
    for name, (hits, st) in adaptive.items():
        got = {}
        for q, i, _ in hits:
            got.setdefault(q, set()).add(i)
        check(st["rounds"] == 1 and all(
            got.get(b) == {int(r) + m for m in range(4)}
            for b, r in enumerate(qrows)),
            f"adaptive {name}: hits differ from the planted groups")

    # 16 queries against the float64 brute force on the card: 8 planted
    # rows, 8 fresh vectors (a dense score boundary)
    Q16 = np.concatenate([V_q[:8], np.clip(np.rint(rng.normal(
        0, 150, size=(8, D))), -600, 600).astype(np.int32)])
    bs, bi = _brute_force(chunks, Q16, ANN_K)
    Di16, Ii16 = index.search(Q16, ANN_K)
    check(np.array_equal(Ii16, bi[:, :ANN_K].astype(np.int32))
          and np.array_equal(Di16, bs[:, :ANN_K].astype(np.float32)),
          "int8 engine (D, I) differ from the float64 brute force")
    Df16, If16 = flat.search(normalize_l2(Q16.astype(np.float32)), ANN_K)
    d_err = float(np.abs(Df16 - bs[:, :ANN_K]).max())
    check(d_err <= 1e-5, f"f32 engine D off the brute force by {d_err}")
    gap = np.diff(-bs, axis=1)                     # gap to the next rank
    for b in range(16):
        for r in range(ANN_K):
            sure = gap[b, r] > 1e-5 and (r == 0 or gap[b, r - 1] > 1e-5)
            check(not sure or If16[b, r] == bi[b, r],
                  f"f32 engine I[{b}, {r}] differs from the brute force")
    say(f"[ann] 16 queries: int8 (D, I) equal the float64 brute force; f32 "
        f"D within {d_err:.2e}, I equal outside 1e-5 near-ties")

    # kernels against their plain versions at the path's shapes
    qp = ii.query_planes(V_q, index.L, "cuda")
    valid = min(ANN_CHUNK, N)
    db = index._stack[0]
    check(torch.equal(pw.scan_scores(qp, db, index._inv_n[0], valid),
                      pw.scan_scores_plain(qp, db, index._inv_n[0], valid)),
          "scan kernel differs from plain")
    # the pooled (query, row) pairs that fall in chunk 0
    flag = pw.range_flag("cuda")
    _, i_dev, _ = index._pool(qp, ANN_B, index.pool_for(ANN_K), flag)
    pw.check_range_flag(flag)
    in0 = (i_dev >= 0) & (i_dev < ANN_CHUNK)
    qrow = torch.arange(ANN_B, device="cuda")[:, None].expand_as(i_dev)
    rc = torch.stack([qrow[in0], i_dev[in0]], 1).to(torch.int32) \
        .contiguous()
    _check_partials(qp, rc, index.L, db)
    say(f"[ann] scan ({qp.shape[1]} x {db.shape[1]}, P={db.shape[0]}) and "
        f"partials on two operands ({len(rc)} pooled pairs): exact")
    _check_select_shapes(index, qp, N, valid, errs)
    return launches


def _check_select_shapes(index, qp, N, valid, errs):
    """Kernel K at the ANN path's shapes on chunk 0's (B, 262,144) scores,
    each bit-equal to its plain version: the int8 search's (merged into the
    pool chunk 1 leaves, kc = W0 = pool_for(k) = 114), the f32 search's (kc
    = W0 = 50), the adaptive search's level 4 (kc = W0 = pool_for(50 *
    3^4) = 4,556) and its deepest level (kc = R, W0 = 0)."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ann import select as sel
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    c1 = min(1, index._stack.shape[0] - 1)
    v1 = min(ANN_CHUNK, N - c1 * ANN_CHUNK)
    sc0 = pw.scan_scores(qp, index._stack[0], index._inv_n[0], valid)[:ANN_B]
    sc1 = pw.scan_scores(qp, index._stack[c1], index._inv_n[c1], v1)[:ANN_B]
    B, R = sc0.shape
    empty = torch.empty((B, 0), dtype=torch.int64, device="cuda")
    shapes = (("int8", index.pool_for(ANN_K)), ("f32", ANN_K),
              ("level 4", index.pool_for(ANN_K * 3 ** 4)), ("kc = R", R))
    for name, k in shapes:
        kc = min(k, R)
        best = empty if kc == R else sel.select_chunk(
            sc1, c1 * ANN_CHUNK, v1, N, kc, empty, kc)[2]
        args = (sc0, 0, valid, N, kc, best, kc)
        errs["select"] = max(errs["select"], _select_err(
            sel.select_chunk(*args), sel.select_chunk_plain(*args),
            f"phase 4's {name} shape"))
        say(f"[ann] select (K) {name} (kc = {kc}, W0 = {best.shape[1]}, "
            f"regime {sel.regime(kc, R)}) on {B} x {R} scores: bit-equal")


# ---------------------------------------------------------------------------
# phase 5: the beyond-memory streaming engine on phase 2's db
# ---------------------------------------------------------------------------

def phase_stream(N, work):
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm

    db_path = os.path.join(work, "db")
    L = pm.pick_limbs(max(1, DbFolder(db_path).max_component()))
    tile = 2048
    npad = (N + tile - 1) // tile * tile
    # half of the JAX rule's plane bytes: the planes do not "fit"
    budget = pm.num_planes(L) * npad * D // 2

    _build.reset_launch_counts()
    mc.compute_pairwise_shard(db_path, os.path.join(work, "mat_stream"),
                              device_budget_bytes=budget, device="cuda",
                              verbose=False)
    launches = _build.launch_counts()
    stages = mc.LAST_STAGES
    check(stages["mode"] == "fused-streaming",
          f"budget {budget} did not stream (mode {stages['mode']})")
    say(f"[stream] N={N} d={D} budget {budget} B: {stages['row_groups']} "
        f"row groups x {stages['windows']} windows, {stages['tiles_swept']} "
        f"tile sweeps; launches {launches}")
    _same_shards(os.path.join(work, "mat"), os.path.join(work, "mat_stream"),
                 1, "streaming shard vs phase 2's resident shard")
    say("[stream] shard byte-equal to phase 2's resident shard")
    for k in STREAM_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the "
                               "streaming path")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the two-phase engine (the JAX package's Pallas kernel's path)
# ---------------------------------------------------------------------------

TWO_PHASE_KERNELS = ("count", "sweep")


def _count_state(P, nt, tile, seed):
    """(planes, thr) of nt x tile rows at d = D on the card: P = 3 (L = 2,
    |v| <= 600) or P = 6 (L = 3, an int16-like db, |v| <= 30,000), normal
    random vectors with rows 1-4 copies of row 0."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    m = {3: 600, 6: 30000}[P]
    L = pm.pick_limbs(m)
    g = torch.Generator(device="cuda").manual_seed(seed)
    V = (torch.randn((nt * tile, D), generator=g, device="cuda") * m / 4) \
        .round_().clamp_(-m, m).to(torch.int32)
    V[1:5] = V[0]
    planes = torch.zeros((P, nt * tile, pw.pad_dim(D)), dtype=torch.int8,
                         device="cuda")
    pw.planes_update(planes, pw.decompose_limbs(V, L), 0)
    ns = ((V.double() ** 2).sum(1) / D).cpu().numpy()
    return planes, _row_thresholds(planes, ns, L, D)


def _check_count_append(L, db_path, norms64, errs):
    """Kernels COUNT and APPEND (self-pairs kept: the two-phase
    extraction's call) over the 4 x 4 tiles of 2048^2 of phase 2's first
    8,192 rows (P = 3) and of an int16-like db of that shape (P = 6), one
    tile list on the card: each against its plain version on the card
    (exact), APPEND's counts against COUNT's."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.ops import pallas_pairwise as pp
    tile, nt, cap = 2048, 4, 1 << 22
    V = np.fromfile(os.path.join(db_path, "vectors.bin"), dtype=np.int32,
                    count=nt * tile * D).reshape(nt * tile, D)
    P = pm.num_planes(L)
    check(P == 3, f"phase 2's db has P = {P}, not 3")
    planes = torch.zeros((P, nt * tile, pw.pad_dim(D)), dtype=torch.int8,
                         device="cuda")
    pw.planes_update(planes, pw.decompose_limbs(torch.from_numpy(V).cuda(),
                                                L), 0)
    thr = _row_thresholds(planes, norms64[:nt * tile] ** 2, L, D)
    coords = np.array([(r, c) for r in range(nt) for c in range(nt)],
                      dtype=np.int32)
    tiles = pw.TileList(coords, "cuda")
    for P, (planes, thr) in {3: (planes, thr),
                             6: _count_state(6, nt, tile, seed=3)}.items():
        got = pp.count_tiles(planes, thr, planes, thr, tiles, tile, D)
        want = pp.count_tiles_plain(planes, thr, planes, thr, coords, tile,
                                    D)
        err = int((got - want).abs().max().item())
        errs["count"] = max(errs["count"], err)
        check(err == 0 and int(want.sum()) > 0,
              f"COUNT differs from its plain version at P={P} (max abs err "
              f"{err})")
        rc_k, cnt_k, tot_k = pw.sweep_extract(planes, thr, planes, thr,
                                              tiles, tile, cap, False, D)
        rc_p, cnt_p, tot_p = pw.sweep_extract_plain(
            planes, thr, planes, thr, coords, tile, cap, False, D)
        n = int(tot_p.item())
        check(int(tot_k.item()) == n and torch.equal(cnt_k, cnt_p)
              and np.array_equal(rows_of(rc_k, n), rows_of(rc_p, n)),
              f"APPEND differs from its plain version at P={P}")
        check(torch.equal(cnt_k, got), f"APPEND's counts differ from "
                                       f"COUNT's at P={P}")
        say(f"[two_phase] COUNT and APPEND P={P}: {len(coords)} tiles of "
            f"{tile}^2 ({n} survivors) equal to their plain versions; "
            "APPEND's counts equal COUNT's")


def phase_two_phase(N, work, errs):
    """Phase 2's db through engine="two_phase": resident with finalize
    device (counted) and host, streaming at phase 5's budget and on a mesh
    of two slots of cuda:0; each shard byte-equal to phase 2's fused
    shard."""
    import torch
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh

    db_path = os.path.join(work, "db")
    db = DbFolder(db_path)
    L = pm.pick_limbs(max(1, db.max_component()))
    tile = 2048
    npad = (N + tile - 1) // tile * tile
    budget = pm.num_planes(L) * npad * D // 2
    cuda0 = torch.device("cuda", 0)
    runs = [("two_phase device", dict(engine="two_phase", finalize="device")),
            ("fused", {}),
            ("two_phase host", dict(engine="two_phase", finalize="host")),
            ("two_phase streaming", dict(engine="two_phase",
                                         device_budget_bytes=budget)),
            ("two_phase 2 slots", dict(engine="two_phase",
                                       mesh=Mesh([cuda0, cuda0])))]
    stages, launches = {}, {}
    total = {k: 0 for k in _build.launch_counts()}
    mc.clear_device_cache()
    for name, kw in runs:
        if name == "fused":
            mc.clear_device_cache()          # the fused shard stages anew
        out = os.path.join(work, "two_phase_" + name.replace(" ", "_"))
        _build.reset_launch_counts()
        mc.compute_pairwise_shard(db_path, out, device="cuda", verbose=False,
                                  **kw)
        launches[name] = _build.launch_counts()
        stages[name] = dict(mc.LAST_STAGES)
        if name != "fused":
            total = {k: total[k] + launches[name][k] for k in total}
        _same_shards(os.path.join(work, "mat"), out, 1,
                     f"{name} shard vs phase 2's fused shard")
        say(f"[two_phase] {name}: mode {stages[name]['mode']}, "
            f"{stages[name]['pairs_written']} pairs, launches "
            f"{launches[name]}")
    mc.clear_device_cache()
    for name, _ in runs:
        if name == "fused":
            continue
        lc, st = launches[name], stages[name]
        check(st["mode"].startswith("two_phase"), f"{name}: mode {st['mode']}")
        check(st["reruns"] == 0, f"{name}: {st['reruns']} reruns")
        for k in TWO_PHASE_KERNELS:
            check(lc[k] > 0, f"{name}: kernel {k} was not launched ({lc})")
        if name != "two_phase host":
            check(lc["partials"] > 0, f"{name}: kernel X not launched")
    check(launches["two_phase host"]["partials"] == 0,
          "finalize=host launched kernel X")
    check(stages["two_phase host"]["stage_ms"]
          < 0.05 * stages["fused"]["stage_ms"],
          "the two-phase shard after the fused one staged again")
    check(stages["two_phase device"]["candidates"]
          == stages["two_phase host"]["candidates"]
          == stages["two_phase 2 slots"]["candidates"],
          "the resident two-phase runs' candidates differ")
    lc = launches["two_phase device"]
    say(f"[two_phase] every shard byte-equal to phase 2's fused shard; "
        f"kernel COUNT launches on the counted run {lc['count']}, APPEND "
        f"{lc['sweep']}, X {lc['partials']}; reruns 0")
    _, norms64 = db.names_and_norms()
    _check_count_append(L, db_path, norms64, errs)
    return total


# ---------------------------------------------------------------------------
# phase 6: the MinHash strategy (kernels G, C and M)
# ---------------------------------------------------------------------------

MH_N, MH_GROUPS, MH_HEAVY = 8192, 128, 64


def phase_minhash(work, errs):
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.bench_data import (
        GROUP, synth_hashes_file)
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh

    # (a) the toy fixture, in toy_db_256's order
    toy = os.path.join(ROOT, "tests", "fixtures", "ref_toy")
    hashes = os.path.join(toy, "all_hashes_toy.txt")
    db = os.path.join(toy, "toy_db_256")
    names, _ = DbFolder(db).names_and_norms()
    named = dict(parse_hashes_file(hashes))
    uniq = [np.unique(named[n]) for n in names]
    n = len(uniq)
    _build.reset_launch_counts()
    out = os.path.join(work, "mh_toy")
    mc.compute_minhash_shard(hashes, out, db_folder=db, device="cuda",
                             verbose=False)
    launches = _build.launch_counts()
    inter = np.zeros((n, n), dtype=np.int64)
    for i in range(n):
        for j in range(i, n):
            inter[i, j] = inter[j, i] = len(np.intersect1d(
                uniq[i], uniq[j], assume_unique=True))
    got = mh.pairwise_intersections([named[x] for x in names], device="cuda")
    check(np.array_equal(got, inter),
          "toy intersections differ from np.intersect1d")
    sizes = np.array([len(u) for u in uniq], dtype=np.int64)
    r, c = np.nonzero(np.ones((n, n), dtype=bool))
    want = _minhash_triples_oracle(sizes, r, c, inter[r, c])
    check(_triples(out, n) == want, "toy MinHash shard differs from the "
                                    "np.intersect1d oracle")
    say(f"[minhash] toy: {n} sets ({int(sizes.sum())} hashes), every pair's "
        f"intersection equals np.intersect1d; shard equals its oracle "
        f"({len(want)} pairs)")

    # (b) N = 8,192 synthetic sets, the counted run
    path = os.path.join(work, "mh_hashes.txt")
    synth_hashes_file(path, MH_N, MH_GROUPS, MH_HEAVY)
    out = os.path.join(work, "mh_big")
    _build.reset_launch_counts()
    mc.compute_minhash_shard(path, out, device="cuda", verbose=False)
    counted = _build.launch_counts()
    split = {k: mc.LAST_STAGES[k] for k in ("heavy_min", "heavy_hashes",
                                            "light_postings",
                                            "light_cooccurrences")}
    # the groups' hashes are held by 4 sets, under N / 96: all light
    check(split["heavy_hashes"] == 0 and counted["gram"] == 0
          and counted["cooc"] > 0 and counted["mhkeep"] > 0,
          f"the N={MH_N} shard's split {split}, launches {counted}")
    # the planted groups' shared hashes as the heavy class: kernel G in
    # place of kernel C, the same bytes
    mc.clear_device_cache()
    threshold = mh.heavy_threshold
    mh.heavy_threshold = lambda p, n: 4
    _build.reset_launch_counts()
    try:
        mc.compute_minhash_shard(path, os.path.join(work, "mh_big_heavy"),
                                 device="cuda", verbose=False)
    finally:
        mh.heavy_threshold = threshold
        mc.clear_device_cache()
    heavy = _build.launch_counts()
    check(heavy["gram"] > 0 and mc.LAST_STAGES["heavy_hashes"] > 0,
          f"the shard with the groups' hashes heavy launched {heavy}")
    _same_shards(out, os.path.join(work, "mh_big_heavy"), 1,
                 "the MinHash shard with the groups' hashes heavy")
    named = parse_hashes_file(path)
    sets = [h for _, h in named]
    got = _triples(out, MH_N)
    want = _minhash_oracle(sets)
    check(got == want, "MinHash shard differs from the sparse oracle")
    planted = {(g * GROUP + a, g * GROUP + b) for g in range(MH_GROUPS)
               for a in range(GROUP) for b in range(GROUP)}
    check(planted <= set(got), "a planted pair is missing from the shard")
    check(all((i, i) in got for i in range(MH_N)),
          "a self-pair is missing from the shard")
    rng = np.random.default_rng(4)
    uniq = [np.unique(h) for h in sets]
    sizes = np.array([len(u) for u in uniq], dtype=np.int64)
    flat = np.concatenate(uniq)
    owner = np.repeat(np.arange(MH_N), sizes)
    for i in rng.choice(MH_N, 64, replace=False).tolist():
        # every column's exact count: membership of all hashes in set i
        pos = np.minimum(np.searchsorted(uniq[i], flat), sizes[i] - 1)
        counts = np.bincount(owner[uniq[i][pos] == flat], minlength=MH_N)
        cols = np.nonzero(counts)[0]
        check(all(len(np.intersect1d(uniq[i], uniq[j], assume_unique=True))
                  == counts[j] for j in cols), f"row {i}: counts differ from "
                                               "np.intersect1d")
        row = _minhash_triples_oracle(sizes, np.full(MH_N, i), np.arange(
            MH_N), counts.astype(np.int64))
        check({k: v for k, v in got.items() if k[0] == i} == row,
              f"row {i} of the MinHash shard differs from its exact counts")
    say(f"[minhash] N={MH_N}: {len(named)} sets, universe "
        f"{int(len(np.unique(flat)))} hashes ({split}); "
        f"shard equals the sparse oracle ({len(want)} pairs), planted and "
        f"self-pairs present, 64 sampled rows exact, the same with the "
        f"groups' hashes heavy; launches {counted}, heavy {heavy}")

    main = _minhash_kernels(errs)
    for lc in (counted, heavy, main):
        for k, v in lc.items():
            launches[k] += v
    return launches


def _minhash_kernels(errs):
    """Kernels G, C and M against their plain versions at the main path's
    shapes: one shard (3,072 rows x 24,576 sets) of the benchmark's MinHash
    collection (portbench/configs/sra_minhash_exact.json, its hashes shared
    by Zipf popularity), staged on the card at the derived threshold. The
    shard's run through ops.minhash.shard_triples is counted alone and must
    launch all three; its kept triples equal the plain kernels'. -> its
    launch counts."""
    import torch
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ops import minhash as mh
    from portbench import gen_hashes
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sra_minhash_exact.json")) as f:
        cfg = json.load(f)
    n = int(cfg["num_sets"])
    b, e = 3 * n // 8, 4 * n // 8
    sets = gen_hashes.make_sets(cfg, 2**31 + 5, "cuda")
    flat = sets["hashes"].cpu().numpy().view(np.uint64)
    off = sets["offsets"].cpu().numpy()
    del sets
    st = mh.stage_sets(np.split(flat, off[1:-1]), device="cuda")
    del flat
    check(st.n_heavy > 0 and st.n_post > 0,
          f"the collection's split: {st.n_heavy} heavy, {st.n_post} light")
    _build.reset_launch_counts()
    record = {}
    r, c, inter = mh.shard_triples(st, b, e, record)
    counted = _build.launch_counts()
    for k in MINHASH_KERNELS:
        check(counted[k] > 0, f"kernel {k} was not launched by the MinHash "
                              f"shard ({counted})")

    G = mh.gram_rows(st.heavy, b, e)
    err = _gram_rows_err(st.heavy, b, e)
    check(err == 0, f"kernel G differs from plain by {err} on the shard")
    errs["gram"] = max(errs["gram"], err)
    want = G.clone()
    cg = torch.zeros(1, dtype=torch.int64, device="cuda")
    cw = torch.zeros_like(cg)
    mh.cooc_accumulate(G, st.post_sets, st.post_off, b, e, cg)
    mh.cooc_accumulate_plain(want, st.post_sets, st.post_off, b, e, cw)
    err = int((G - want).abs().max())
    del want
    check(err == 0, f"kernel C differs from plain by {err} on the shard")
    check(int(cg) == int(cw) == record["light_cooccurrences"],
          f"kernel C's increments {int(cg)}, plain {int(cw)}, the shard's "
          f"{record['light_cooccurrences']}")
    errs["cooc"] = max(errs["cooc"], err)

    kept = record["kept"]
    got, gk = mh.keep_shard(G, st.sizes, b, e, kept)
    plain, pk = mh.keep_shard_plain(G, st.sizes, b, e, kept)
    check(int(gk) == int(pk) == kept == len(r),
          f"kernel M kept {int(gk)}, plain {int(pk)}, the shard {kept}")
    got = got[:kept].cpu().numpy()
    plain = plain[:kept].cpu().numpy()
    got = got[np.lexsort((got[:, 0] >> 32, got[:, 0] & 0xFFFFFFFF))]
    check(np.array_equal(got[:, 0], plain[:, 0]),
          "kernel M kept other pairs than its plain version")
    err = int(np.abs(got[:, 1] - plain[:, 1]).max()) if kept else 0
    check(err == 0, f"kernel M's counts differ from plain by {err}")
    errs["mhkeep"] = max(errs["mhkeep"], err)
    check(np.array_equal(r, plain[:, 0] & 0xFFFFFFFF)
          and np.array_equal(c, plain[:, 0] >> 32)
          and np.array_equal(inter, plain[:, 1]),
          "the shard's triples differ from the plain kernels'")
    say(f"[minhash] main shapes: {n} sets, {int(off[-1])} hashes, heavy from "
        f"{st.heavy_min} sets ({st.n_heavy} heavy, {st.n_post} light "
        f"postings); rows {b}..{e}: G, C ({int(cg)} increments) and M "
        f"({kept} kept) equal their plain versions; launches {counted}")
    del G, st
    torch.cuda.empty_cache()
    return counted


# ---------------------------------------------------------------------------
# phase 8: the multi-device layer on two slots of the one card
# ---------------------------------------------------------------------------

MESH_KERNELS = ("projection", "sweep", "keep", "partials", "scan", "select")
PIPE_B = 4096           # phase 2's first sets: its planted groups of 4


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ann_queries(N, chunks):
    """Phase 4's B planted query rows (the same draw) -> (int32 (B, D))."""
    import torch
    rng = np.random.default_rng(9)
    groups = np.sort(rng.choice(N // ANN_GROUP_STRIDE, ANN_B, replace=False))
    rows = (groups * ANN_GROUP_STRIDE).tolist()
    return torch.cat([chunks[r // ANN_CHUNK][1][r % ANN_CHUNK][None]
                      for r in rows]).cpu().numpy()


def _calls(fn, reps=3):
    """The result of each of ``reps`` calls of fn()."""
    return [fn() for _ in range(reps)]


def _same_up_to_ties(I, If, Df, what):
    """Fails unless every (B, k) index of I equals If's or sits in a tie
    of the reference scores Df (a gap of at most 1e-5 to a neighbour)."""
    gap = np.abs(np.diff(Df, axis=1))
    for b, r in zip(*np.nonzero(I != If)):
        near = [gap[b, x] for x in (r - 1, r) if 0 <= x < Df.shape[1] - 1]
        check(min(near, default=0.0) <= 1e-5,
              f"{what} I[{b}, {r}] differs outside a tie")


def _pipeline_batch(work):
    """Phase 2's first PIPE_B hash sets as the pipeline step's padded
    (B, H) uint32 halves and (B,) counts."""
    from metagenome_vector_sketches_tpu_torch.io.hashes import (
        parse_hashes_file)
    path = os.path.join(work, "pipe_hashes.txt")
    with open(os.path.join(work, "all_hashes.txt")) as f, \
            open(path, "w") as g:
        for _, ln in zip(range(PIPE_B), f):
            g.write(ln)
    sets = [h.astype(np.uint64) for _, h in parse_hashes_file(path)]
    H = max(len(h) for h in sets)
    full = np.zeros((len(sets), H), dtype=np.uint64)
    for b, h in enumerate(sets):
        full[b, :len(h)] = h
    counts = np.array([len(h) for h in sets], dtype=np.int32)
    return ((full >> np.uint64(32)).astype(np.uint32),
            (full & np.uint64(0xFFFFFFFF)).astype(np.uint32), counts, sets)


def _pipeline_plain(sets, n_slots, L):
    """The pipeline step's survivors through the plain versions on the card
    (projection, planes, the float32 combine, the raw retention test); the
    squared norms are taken per slot block, as the step takes them."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.ops import projection as pj
    flat = np.concatenate(sets).view(np.int64)
    offsets = np.concatenate([[0], np.cumsum([len(h) for h in sets])])
    vecs = pj.project_batch_plain(torch.from_numpy(flat).cuda(),
                                  torch.from_numpy(offsets).cuda(), D)
    sqrt_d = torch.full((1, 1), float(np.float32(np.sqrt(D))), device="cuda")
    norms = torch.cat([((x / sqrt_d) * (x / sqrt_d)).sum(dim=1) for x in
                       vecs.to(torch.float32).chunk(n_slots)])
    planes = pw.karatsuba_planes(pw.decompose_limbs(vecs, L))
    mask = pw.retention_mask(pw.approx_dot_f32(planes, planes), norms, norms,
                             D, 1.0, 0.0)
    return mask.sum(dim=1).to(torch.int32), vecs


def _pipeline_topk_plain(vecs, k):
    """The pipeline step's float32 top-k through plain PyTorch on the card:
    L2-normalised sketches, their float32 product (TF32 off), torch.topk
    -> (scores (B, k), indices (B, k)) on the host."""
    import torch
    from metagenome_vector_sketches_tpu_torch.ann.flat_index import (
        fp32_matmul)
    vf = vecs.to(torch.float32)
    unit = vf * torch.rsqrt(torch.clamp((vf * vf).sum(dim=1, keepdim=True),
                                        min=1e-30))
    with fp32_matmul():
        d, i = torch.topk(unit @ unit.T, k, dim=1)
    return d.cpu().numpy(), i.cpu().numpy()


def phase_mesh(N, ann_n, work):
    import torch
    import torch.distributed as dist
    from metagenome_vector_sketches_tpu_torch import _build
    from metagenome_vector_sketches_tpu_torch.ann import int_index as ii
    from metagenome_vector_sketches_tpu_torch.ann.distributed import (
        DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu_torch.ann.flat_index import (
        FlatIPIndex, normalize_l2)
    from metagenome_vector_sketches_tpu_torch.bench_data import GROUP
    from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
    from metagenome_vector_sketches_tpu_torch.matrix import compute as mc
    from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm
    from metagenome_vector_sketches_tpu_torch.parallel import multihost
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    from metagenome_vector_sketches_tpu_torch.parallel.pairwise import (
        distributed_topk)
    from metagenome_vector_sketches_tpu_torch.parallel.pipeline import (
        make_pipeline_step)

    cuda0 = torch.device("cuda", 0)
    mesh = Mesh([cuda0, cuda0])
    db_path = os.path.join(work, "db")
    L = pm.pick_limbs(max(1, DbFolder(db_path).max_component()))
    tile = 2048
    budget = pm.num_planes(L) * ((N + tile - 1) // tile * tile) * D // 2

    # set-up and the single-device references (before the counted run):
    # phase 4's vectors again, its engines' results, the int16 db folder of
    # its vectors, the pipeline's batch, a resident shard on the warm card
    chunks = _ann_chunks(ann_n)
    V_q = _ann_queries(ann_n, chunks)
    single = ii.IntExactIndex.from_device_chunks(list(chunks), D)
    singles = _calls(lambda: single.search(V_q, ANN_K))
    Di, Ii = singles[0]
    del single
    U = torch.cat([v.float() for _, v in chunks])
    U /= U.norm(dim=1, keepdim=True).clamp_(min=1e-30)
    flat = FlatIPIndex.from_device_chunks(
        [(s, U[s:s + ANN_CHUNK]) for s in range(0, ann_n, ANN_CHUNK)], D)
    Qn = normalize_l2(V_q.astype(np.float32))
    Df, If = flat.search(Qn, ANN_K)
    del flat
    V16 = np.empty((ann_n, D), dtype=np.int16)
    for s, v in chunks:
        V16[s:s + v.shape[0]] = v.to(torch.int16).cpu().numpy()
    del chunks
    ann_db = os.path.join(work, "ann_db")
    DbFolder.write(ann_db, [f"ACC{i:07d}" for i in range(ann_n)], V16, D,
                   use_int16=True)
    del V16
    hi, lo, counts, sets = _pipeline_batch(work)
    mc.compute_pairwise_shard(db_path, os.path.join(work, "mesh_single"),
                              device="cuda", verbose=False)
    mc.clear_device_cache()
    torch.cuda.synchronize()

    # the counted run of the mesh paths
    _build.reset_launch_counts()
    mc.compute_pairwise_shard(db_path, os.path.join(work, "mesh_mat"),
                              device="cuda", verbose=False, mesh=mesh)
    mc.compute_pairwise_shard(db_path, os.path.join(work, "mesh_stream"),
                              device_budget_bytes=budget, device="cuda",
                              verbose=False, mesh=mesh)
    stream_mode = mc.LAST_STAGES["mode"]
    mc.clear_device_cache()
    dist_idx = DistributedIntExactIndex.from_dbfolder(ann_db, mesh=mesh)
    dists = _calls(lambda: dist_idx.search(V_q, ANN_K))
    del dist_idx
    multihost.initialize(coordinator_address=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, device="cuda")
    try:
        backend = dist.get_backend()
        gmesh = Mesh([cuda0, cuda0], group=dist.group.WORLD)
        folders = multihost.compute_pairwise_multihost(
            db_path, os.path.join(work, "mesh_multihost"), num_shards=2,
            mesh=gmesh, device="cuda", verbose=False)
        mc.clear_device_cache()
        q_dev = torch.from_numpy(Qn).cuda()
        topks = _calls(lambda: distributed_topk(gmesh, q_dev, U, ANN_K))
        step = make_pipeline_step(gmesh, D, L, ANN_K)
        steps = _calls(lambda: step(hi, lo, counts))
    finally:
        dist.destroy_process_group()
    launches = _build.launch_counts()
    del U

    # the checks
    for k in MESH_KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the mesh "
                               "paths")
    check(stream_mode == "fused-streaming",
          f"budget {budget} did not stream on the mesh ({stream_mode})")
    for name in ("mesh_mat", "mesh_stream", "mesh_single"):
        _same_shards(os.path.join(work, "mat"), os.path.join(work, name), 1,
                     f"{name} vs phase 2's shard")
    check(backend == "nccl", f"the CUDA world's backend is {backend}")
    check(folders == [os.path.join(work, "mesh_multihost", f"shard_{s}")
                      for s in (0, 1)], f"multihost wrote {folders}")
    _same_shards(os.path.join(work, "cache_mat"),
                 os.path.join(work, "mesh_multihost"), 2,
                 "NCCL world-of-one shards vs the single-device shards")
    say("[mesh] 2-slot shards (resident and streaming) byte-equal to phase "
        "2's; the NCCL world of one's shards 0 and 1 of 2 byte-equal to "
        "the single-device ones")
    for c, (Dd, Id) in enumerate(singles[1:] + dists):
        check(np.array_equal(Id, Ii) and np.array_equal(Dd, Di),
              f"int8 search call {c} (D, I) differ from the single-device "
              "index's first call")
    say(f"[mesh] 2-slot int8 index from the db folder: (D, I) of each of "
        f"{len(dists)} calls equal the single-device index's "
        f"(N={ann_n}, B={ANN_B}, k={ANN_K})")
    d_err = 0.0
    for c, (D8, I8) in enumerate(topks):
        D8, I8 = D8.cpu().numpy(), I8.cpu().numpy()
        d_err = max(d_err, float(np.abs(np.sort(D8, 1)
                                        - np.sort(Df, 1)).max()))
        _same_up_to_ties(I8, If, Df, f"2-slot f32 top-k call {c}")
    check(d_err <= 1e-5, f"2-slot f32 top-k D off the flat index's by {d_err}")
    say(f"[mesh] 2-slot f32 top-k over NCCL, {len(topks)} calls: D within "
        f"{d_err:.2e} of the flat index's, I equal up to ties")
    want, vecs = _pipeline_plain(sets, gmesh.size, L)
    Dp, Ip = _pipeline_topk_plain(vecs, ANN_K)
    grouped = min(PIPE_B, max(1, N // 64) * GROUP)    # phase 2's groups
    p_err = 0.0
    for c, (surv, top_i, top_d) in enumerate(steps):
        check(torch.equal(surv, want), f"pipeline call {c}: survivors differ "
                                       "from the plain count")
        check(bool((surv[:grouped] >= 4).all()) and bool((surv >= 1).all()),
              f"pipeline call {c}: a row lost itself or a planted row its "
              "group")
        top_d = top_d.cpu().numpy()
        check(bool(np.isfinite(top_d).all()),
              f"pipeline call {c}: a top-k score is not finite")
        p_err = max(p_err, float(np.abs(top_d - Dp).max()))
        _same_up_to_ties(top_i.cpu().numpy(), Ip, Dp,
                         f"pipeline call {c} top-k")
    check(p_err <= 1e-5, f"pipeline top-k scores off the plain float32 "
                         f"top-k by {p_err}")
    check(pm.pick_limbs(max(1, int(vecs.abs().max()))) <= L,
          "the pipeline batch needs more limbs than its step")
    surv = steps[0][0]
    say(f"[mesh] pipeline step on {PIPE_B} of phase 2's sets (L={L}), "
        f"{len(steps)} calls: survivors equal the plain count "
        f"(min {int(surv.min())}, max {int(surv.max())}); top-{ANN_K} "
        f"scores within {p_err:.2e} of a plain float32 top-k, indices "
        "equal up to ties")

    say(f"[mesh] launches {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=65536,
                    help="accessions of the main-path run (default 65536)")
    ap.add_argument("--ann-n", type=int, default=1 << 20,
                    help="rows of the ANN phase's index (default 1,048,576)")
    args = ap.parse_args()
    if args.ann_n % 2:
        ap.error("--ann-n must be even (phase 8 splits it over two slots)")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from metagenome_vector_sketches_tpu_torch import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    lib_path = _build.build()
    _build.library()
    say(f"[build] {os.path.relpath(lib_path, ROOT)} built and loaded")

    errs = {k: 0 for k in _build.KERNELS}
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT)
    try:
        phase_kernels(errs)
        paths = [phase_main(args.n, work)]
        paths.append(phase_stream(args.n, work))
        paths.append(phase_two_phase(args.n, work, errs))
        paths.append(phase_minhash(work, errs))
        phase_cli(work)
        paths.append(phase_tools(args.n, work))
        paths.append(phase_ann(args.ann_n, errs))
        paths.append(phase_mesh(args.n, args.ann_n, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check("jax" not in sys.modules, "the port imported jax")
    jax_pkg = sorted(m for m in sys.modules
                     if m.split(".")[0] == "metagenome_vector_sketches_tpu")
    check(not jax_pkg, f"the port imported the JAX package: {jax_pkg[:5]}")

    kernels = [{"name": k, "route": "cuda",
                "source": f"{PKG}/csrc/{SOURCES[k]}", "replaces": REPLACES[k],
                "launches": sum(p[k] for p in paths),
                "max_abs_err": errs[k]}
               for k in _build.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
