"""Two real processes on torch.distributed (gloo), each with a 2-slot CPU
mesh (the port's counterpart of test_distributed.py): the strided shards
of compute_pairwise_multihost, the sharded sweep counts, the distributed
top-k and the pipeline step over the global mesh, and both distributed
indexes built collectively from uneven per-process row blocks. The parent
merges the shard folders and holds them against the oracle, the JAX
package's single-device shards and the port's single-device shards."""

import filecmp
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from helpers import assert_matrix_matches_oracle  # noqa: E402
from metagenome_vector_sketches_tpu.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")
# the whole run's limit: the processes are killed past it
TIMEOUT_S = 100

_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
    db_path = sys.argv[4]; out_path = sys.argv[5]

    from metagenome_vector_sketches_tpu_torch.parallel import multihost
    from metagenome_vector_sketches_tpu_torch.parallel.mesh import Mesh
    multihost.initialize(coordinator_address=coord, num_processes=nproc,
                         process_id=pid, device="cpu")
    assert dist.get_backend() == "gloo"
    assert multihost.process_info() == (pid, nproc)
    assert multihost.host_shards(4) == list(range(pid, 4, nproc))
    assert multihost.global_mesh(device="cpu").process_count == nproc
    cpu = torch.device("cpu")
    mesh = Mesh([cpu, cpu], group=dist.group.WORLD)   # 2 slots a process
    assert mesh.global_size == 2 * nproc

    # 1) this process's strided shards, each mesh-parallel over its slots
    folders = multihost.compute_pairwise_multihost(
        db_path, out_path, num_shards=4, tile_rows=8, verbose=False,
        mesh=mesh, device="cpu")
    assert folders == [os.path.join(out_path, f"shard_{{s}}")
                       for s in range(pid, 4, nproc)], folders

    # 2) sharded sweep counts over the global mesh: this process's rows
    #    against every process's, equal to the one-process count
    from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
    from metagenome_vector_sketches_tpu_torch.parallel import pairwise as par
    rng = np.random.default_rng(3)                  # same on every process
    N, d = 32, 64
    V = rng.integers(-300, 301, size=(N, d)).astype(np.int32)
    V[1] = V[0]
    V[20] = V[5] + 1
    thr = (np.einsum("ij,ij->i", V.astype(np.float64), V.astype(np.float64))
           / d).astype(np.float32)
    limbs = pw.decompose_limbs(torch.from_numpy(V), 2)
    rows = slice(pid * N // nproc, (pid + 1) * N // nproc)
    got = par.sharded_pairwise_counts(mesh, limbs[:, rows], thr[rows], d)
    want = par.sharded_pairwise_counts(Mesh([cpu]), limbs, thr, d)[rows]
    assert torch.equal(got, want), (got, want)
    assert int(got.sum()) > 0

    # 3) distributed top-k: rows split over processes and slots
    from metagenome_vector_sketches_tpu_torch.ann.flat_index import (
        normalize_l2)
    rng = np.random.default_rng(5)
    N, d, B, k = 64, 32, 3, 5
    V = normalize_l2(rng.normal(size=(N, d)).astype(np.float32))
    Q = normalize_l2(rng.normal(size=(B, d)).astype(np.float32))
    D, I = par.distributed_topk(mesh, Q, V[pid * 32:(pid + 1) * 32], k)
    scores = Q.astype(np.float64) @ V.astype(np.float64).T
    for b in range(B):
        assert set(I[b].tolist()) == set(np.argsort(-scores[b])[:k].tolist())

    # 4) the pipeline step over the global mesh: survivors and top-k equal
    #    the one-process step's on the whole batch
    from metagenome_vector_sketches_tpu_torch.parallel.pipeline import (
        make_pipeline_step)
    rng = np.random.default_rng(13)
    Bp, H = 8, 64
    hi = rng.integers(0, 1 << 32, size=(Bp, H), dtype=np.uint64).astype(
        np.uint32)
    lo = rng.integers(0, 1 << 32, size=(Bp, H), dtype=np.uint64).astype(
        np.uint32)
    hi[1], lo[1] = hi[0], lo[0]
    cnt = rng.integers(1, H + 1, size=Bp).astype(np.int32)
    cnt[1] = cnt[0]
    mine = slice(pid * Bp // nproc, (pid + 1) * Bp // nproc)
    s_g, i_g, d_g = make_pipeline_step(mesh, 128, 1, 3)(hi[mine], lo[mine],
                                                         cnt[mine])
    s_1, i_1, d_1 = make_pipeline_step(Mesh([cpu]), 128, 1, 3)(hi, lo, cnt)
    assert torch.equal(s_g, s_1[mine]) and torch.equal(i_g, i_1[mine])
    # float32 products of another shape: equal to a few roundings
    assert torch.allclose(d_g, d_1[mine], rtol=0, atol=1e-6)

    # 5) int8-plane exact ANN built collectively from uneven row blocks
    from metagenome_vector_sketches_tpu_torch.ann.distributed import (
        DistributedFlatIPIndex, DistributedIntExactIndex)
    from metagenome_vector_sketches_tpu_torch.ann.int_index import (
        IntExactIndex)
    rng = np.random.default_rng(7)
    Ni, di, ki = 50, 32, 7
    Vi = rng.integers(-300, 301, size=(Ni, di)).astype(np.int32)
    Qi = rng.integers(-300, 301, size=(3, di)).astype(np.int32)
    splits = [0, 22, Ni]
    idx = DistributedIntExactIndex.from_process_shards(
        Vi[splits[pid]:splits[pid + 1]], di, mesh=mesh, chunk_rows=8)
    assert idx.ntotal == Ni, idx.ntotal
    D, I = idx.search(Qi, ki)
    Ds, Is = IntExactIndex(Vi, chunk_rows=8, device="cpu").search(Qi, ki)
    assert np.array_equal(I, Is) and np.array_equal(D, Ds), (I, Is)

    # 6) f32 flat index from per-process blocks (pad rows in the middle)
    rng = np.random.default_rng(11)
    Nf, df, kf = 45, 24, 6
    Vf = normalize_l2(rng.normal(size=(Nf, df)).astype(np.float32))
    Qf = normalize_l2(rng.normal(size=(2, df)).astype(np.float32))
    fsplits = [0, 19, Nf]
    fidx = DistributedFlatIPIndex.from_process_shards(
        Vf[fsplits[pid]:fsplits[pid + 1]], df, mesh=mesh)
    assert fidx.ntotal == Nf, fidx.ntotal
    Df, If = fidx.search(Qf, kf)
    fsc = Qf.astype(np.float64) @ Vf.astype(np.float64).T
    for b in range(2):
        want = np.sort(fsc[b][np.argsort(-fsc[b])[:kf]])
        assert np.allclose(np.sort(Df[b]), want, atol=1e-6), b
        assert np.all(If[b] >= 0) and np.all(If[b] < Nf)

    dist.destroy_process_group()
    print(f"DISTOK {{pid}}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo(tmp_path):
    rng = np.random.default_rng(9)
    n, d = 40, 64
    V = rng.integers(-200, 201, size=(n, d)).astype(np.int32)
    V[1] = V[0] + 1
    V[17] = V[16]
    db = DbFolder.write(str(tmp_path / "db"), [f"S{i}" for i in range(n)],
                        V, d)
    out = tmp_path / "m"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=REPO))
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), "2", coord, db.path,
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, stdout) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and "Address already in use" in stdout:
            pytest.skip(f"coordinator port taken: {stdout[-200:]}")
        assert p.returncode == 0, f"process {pid} failed:\n{stdout[-4000:]}"
        assert f"DISTOK {pid}" in stdout

    # both processes' shards merge into the one-process matrix
    assert sorted(os.listdir(out)) == [f"shard_{s}" for s in range(4)]
    _, norms = db.names_and_norms()
    assert_matrix_matches_oracle(V, norms * norms, d, str(out), n)
    for s in range(4):
        jmc.compute_pairwise_shard(db.path, str(tmp_path / "jax"),
                                   num_shards=4, shard_idx=s, tile_rows=8,
                                   verbose=False)
        tmc.compute_pairwise_shard(db.path, str(tmp_path / "single"),
                                   num_shards=4, shard_idx=s, tile_rows=8,
                                   verbose=False, device="cpu")
        for ref in ("jax", "single"):
            for f in SHARD_FILES:
                assert filecmp.cmp(out / f"shard_{s}" / f,
                                   tmp_path / ref / f"shard_{s}" / f,
                                   shallow=False), (ref, s, f)
