"""The fused end-to-end pipeline step over a mesh (JAX
``parallel/pipeline.py``): sketch (projection) -> pairwise threshold sweep
-> top-k search.

The accession batch is split over the mesh's slots. Each slot projects its
sets with kernel P and decomposes the sketches into limbs; the limbs, the
squared norms and the normalised sketches are gathered (over the slots,
then over processes); each slot counts its rows' survivors against the
whole batch with kernel S (:func:`.pairwise.slot_counts`) and takes the
float32 top-k of its sketches against the gathered batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ann.flat_index import fp32_matmul
from ..ann.select import rank_keys
from ..ops import pairwise as pw
from ..ops import projection as pj
from .mesh import Mesh
from .pairwise import decode_keys, slot_counts, topk_keys


def _csr(hash_hi, hash_lo, counts):
    """(b, H) uint32 hash halves and (b,) valid counts -> (int64 bit
    patterns of the valid hashes, set by set; (b + 1,) int64 offsets)."""
    hi = np.asarray(hash_hi, dtype=np.uint32).astype(np.uint64)
    lo = np.asarray(hash_lo, dtype=np.uint32).astype(np.uint64)
    n = np.clip(np.asarray(counts, dtype=np.int64), 0, hi.shape[1])
    mask = np.arange(hi.shape[1])[None, :] < n[:, None]
    offsets = np.zeros(len(n) + 1, dtype=np.int64)
    np.cumsum(n, out=offsets[1:])
    return ((hi << np.uint64(32)) | lo)[mask].view(np.int64), offsets


def make_pipeline_step(mesh: Mesh, d: int, L: int, k: int):
    """Build the full pipeline step over ``mesh``.

    step(hash_hi, hash_lo, counts): a batch of B hash sets as (B, H) uint32
    high and low halves of each uint64 hash and (B,) valid counts (entries
    past a set's count are ignored), B divisible by the mesh's slots:
      1. project the hash sets -> int32 sketches (kernel P, per slot);
      2. per-row survivor counts against the gathered batch under the RAW
         retention threshold approx / d > 0.05 (|a|^2 + |b|^2) with the
         squared norms of the sketches scaled by 1/sqrt(d) (kernel S; not
         the engine sweep's widened test: at toy scale SLACK_ABS would mark
         every pair a survivor);
      3. L2-normalise, float32 top-k of each sketch against the gathered
         batch (lowest index first among equal scores).
    Returns (survivors (B,) int32, topk_idx (B, kk) int32, topk_scores
    (B, kk) float32), kk = min(k, batch of all processes), this process's
    rows on the lead device."""
    sqrt_d = float(np.float32(np.sqrt(d)))

    def step(hash_hi, hash_lo, counts):
        B = len(counts)
        if B % mesh.size:
            raise ValueError(f"a batch of {B} sets does not split over "
                             f"{mesh.size} slots")
        b = B // mesh.size
        limbs, norms, unit = [], [], []
        for s, dev in enumerate(mesh.devices):
            rows = slice(s * b, (s + 1) * b)
            flat, offsets = _csr(hash_hi[rows], hash_lo[rows], counts[rows])
            with mesh.slot(s):
                vecs = pj.project_batch(flat, offsets, d, dev)
                vf = vecs.to(torch.float32)
                # a device divisor: CUDA divides by a host scalar through
                # its reciprocal, which is not the rounded quotient
                x = vf / torch.full((1, 1), sqrt_d, device=dev)
                norms.append((x * x).sum(dim=1))
                limbs.append(pw.decompose_limbs(vecs, L))
                inv = torch.rsqrt(torch.clamp((vf * vf).sum(dim=1,
                                                            keepdim=True),
                                              min=1e-30))
                unit.append(vf * inv)
        # each slot's parts are handed off to the current stream, which
        # gathers them
        limbs_all = mesh.all_gather(mesh.gather_slots(limbs, 1), 1)
        norms_all = mesh.all_gather(mesh.gather_slots(norms))
        unit_all = mesh.all_gather(mesh.gather_slots(unit))
        survivors = slot_counts(mesh, limbs, norms, limbs_all, norms_all, d,
                                1.0, 0.0)
        ids = torch.arange(unit_all.shape[0])
        tops = []
        with fp32_matmul():
            for s, dev in enumerate(mesh.devices):
                with mesh.slot(s):
                    scores = unit[s] @ unit_all.to(dev).T
                    tops.append(topk_keys(rank_keys(scores, ids.to(dev)),
                                          min(k, unit_all.shape[0])))
        topd, topi = decode_keys(mesh.gather_slots(tops))
        return survivors, topi.to(torch.int32), topd

    return step
