"""MinHash strategy (the reference's historical ``--strategy 1``): EXACT
pairwise intersections of the raw FracMinHash sets.

Port of ``metagenome_vector_sketches_tpu/ops/minhash.py`` (that module
imports jax, so its numpy helpers are copied here, not imported). The
all-vs-all intersection-count matrix is M @ M^T, where M is the (N x U) 0/1
incidence of the sets over the sorted unique-hash universe. U is walked in
chunks: each chunk's (n_pad, u_pad) int8 incidence is built ON THE DEVICE by
one scatter from the CSR positions, uploaded once (the JAX package filled it
on the host with N searchsorted calls per chunk), and kernel G adds the
chunk's Gram into one int32 (n_pad, n_pad) accumulator. int32 is exact: an
intersection is at most min(|A|, |B|) < 2^31. The accumulator is mirrored on
the device and copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..utils.profiling import stage
from .pairwise import D_ALIGN, SWEEP_BLOCK, pad_rows

# stage walls (ms) of the LAST pairwise_intersections call, each with the
# profiler span of the same block (utils.profiling.stage): universe_ms
# (mvs.minhash.universe) the host universe build, gram_ms (mvs.minhash.gram)
# the device scatter + kernel G over every chunk (synchronised), copy_ms
# (mvs.minhash.copy) the mirror and the one device->host copy
LAST_STAGES: dict = {}


def _set_sizes(hash_sets) -> np.ndarray:
    """Unique-element count per input (sets, lists, or arrays)."""
    return np.array(
        [len(s) if isinstance(s, (set, frozenset))
         else len(np.unique(np.asarray(list(s), dtype=np.uint64)))
         for s in hash_sets], dtype=np.int64)


def build_universe(hash_sets) -> tuple[np.ndarray, list[np.ndarray]]:
    """-> (sorted unique hash universe, per-set SORTED positions into it).
    All-empty input (every signature failed to parse) yields an empty
    universe, not a concatenate crash."""
    def as_sorted(s):
        return np.sort(np.asarray(list(s) if isinstance(s, (set, frozenset))
                                  else s, dtype=np.uint64))

    arrs = [as_sorted(s) for s in hash_sets]
    nonempty = [a for a in arrs if len(a)]
    if not nonempty:
        return (np.empty(0, dtype=np.uint64),
                [np.empty(0, dtype=np.int64) for _ in hash_sets])
    universe = np.unique(np.concatenate(nonempty))
    positions = [np.searchsorted(universe, a) for a in arrs]
    return universe, positions


def gram_accumulate_plain(C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gram_accumulate`: the full square,
    as the float64 product of the 0/1 chunk (exact below 2^53)."""
    C += (A.to(torch.float64) @ A.to(torch.float64).T).to(torch.int32)
    return C


def gram_accumulate(C: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """C (n, n) int32 += A @ A^T for an (n, u) int8 incidence chunk A, in
    place, on A's device. On CUDA (kernel G) only the 128 x 128 blocks on
    and above the block diagonal are written, n must be a multiple of 128
    and u of 64 (pad with zero rows and columns); :func:`mirror_upper`
    completes the square after the last chunk. The plain version writes the
    whole square, which mirror_upper leaves as it is."""
    if A.device.type == "cpu":
        return gram_accumulate_plain(C, A)
    n, u = A.shape
    if A.dtype != torch.int8 or A.ndim != 2 or not A.is_contiguous() \
            or A.data_ptr() % 16:
        raise ValueError("A must be a contiguous 16-byte aligned (n, u) int8 "
                         "tensor")
    if n % SWEEP_BLOCK or u % D_ALIGN or n == 0 or u == 0:
        raise ValueError(f"kernel G takes n a multiple of {SWEEP_BLOCK} and u "
                         f"of {D_ALIGN} (got {n} x {u})")
    if C.dtype != torch.int32 or C.shape != (n, n) or not C.is_contiguous() \
            or C.device != A.device:
        raise ValueError(f"C must be a contiguous ({n}, {n}) int32 tensor on "
                         "A's device")
    lib = _build.library()
    with _build.launch_stream(A.device) as stream:
        err = lib.mvs_gram(A.data_ptr(), n, u, C.data_ptr(), n, stream)
    _build.check(err, "gram kernel")
    _build.count_launch("gram")
    return C


def mirror_upper(C: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix whose upper triangle (diagonal included) is
    C's."""
    return torch.triu(C) + torch.triu(C, 1).T


def pairwise_intersections(hash_sets, chunk: int = 1 << 14, *,
                           device) -> np.ndarray:
    """Exact (N, N) int64 intersection-count matrix via chunked incidence
    Grams on ``device``."""
    dev = resolve_device(device)
    LAST_STAGES.clear()
    LAST_STAGES.update(universe_ms=0.0, gram_ms=0.0, copy_ms=0.0, chunks=0)
    n = len(hash_sets)
    with stage("mvs.minhash.universe", LAST_STAGES, "universe_ms"):
        universe, positions = build_universe(hash_sets)
    U = len(universe)
    if U == 0:
        return np.zeros((n, n), dtype=np.int64)

    with stage("mvs.minhash.gram", LAST_STAGES, "gram_ms"):
        lens = torch.tensor([len(p) for p in positions], dtype=torch.int64)
        pos = torch.from_numpy(np.concatenate(positions).astype(np.int64)) \
            .to(dev)
        rows = torch.repeat_interleave(torch.arange(n, dtype=torch.int64),
                                       lens).to(dev)
        # sorted by position, every chunk's entries are one contiguous slice
        pos, order = torch.sort(pos)
        rows = rows[order]
        edges = np.append(np.arange(0, U, chunk), U)
        bounds = torch.searchsorted(pos,
                                    torch.from_numpy(edges).to(dev)).tolist()
        n_pad = pad_rows(n, dev)
        u_pad = (min(chunk, U) + D_ALIGN - 1) // D_ALIGN * D_ALIGN
        M = torch.empty((n_pad, u_pad), dtype=torch.int8, device=dev)
        C = torch.zeros((n_pad, n_pad), dtype=torch.int32, device=dev)
        for k, s in enumerate(edges[:-1].tolist()):
            lo, hi = bounds[k], bounds[k + 1]
            M.zero_()
            M.view(-1)[rows[lo:hi] * u_pad + (pos[lo:hi] - s)] = 1
            gram_accumulate(C, M)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    LAST_STAGES["chunks"] = len(edges) - 1
    with stage("mvs.minhash.copy", LAST_STAGES, "copy_ms"):
        out = mirror_upper(C)[:n, :n].cpu().numpy().astype(np.int64)
    return out


def pairwise_jaccard_minhash(hash_sets, *,
                             device) -> tuple[np.ndarray, np.ndarray]:
    """-> (jaccard (N,N) float64, sizes (N,)) — exact set Jaccard:
    J = |A&B| / (|A| + |B| - |A&B|)."""
    inter = pairwise_intersections(hash_sets, device=device)
    sizes = _set_sizes(hash_sets)
    union = sizes[:, None] + sizes[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        jac = np.where(union > 0, inter / union, 0.0)
    return jac, sizes


def minhash_triples(hash_sets, *, device):
    """Surviving (row, col, value) triples under the reference retention rule
    expressed on the true sets: keep iff intersection > 0.05*(|A|+|B|)
    (float64, as the JAX package). `value` is the raw intersection count,
    analogous to dot/d of the sketch path."""
    inter = pairwise_intersections(hash_sets, device=device)
    sizes = _set_sizes(hash_sets)
    thr = 0.05 * (sizes[:, None] + sizes[None, :])
    keep = inter.astype(np.float64) > thr
    r, c = np.nonzero(keep)
    return r.astype(np.int64), c.astype(np.int64), inter[r, c], sizes
