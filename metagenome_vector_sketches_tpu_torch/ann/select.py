"""Exact top-k selection with the JAX package's tie order (kernel K).

``jax.lax.top_k`` keeps the lowest index among equal scores, and the JAX
engines depend on it for pool membership and for the ranked prefixes that
the adaptive search slices. So every (float32 score, index) pair is packed
into one int64 key that orders as (score descending, index ascending): the
score's bits mapped to an order-preserving int32 in the high word, the
complement of the index in the low word. Keys are distinct for distinct
indices, and score and index decode from the key without a gather. -0.0
ranks as +0.0, its equal. Lanes that carry the one "no row" index have
equal keys; among them the lowest lane (position) comes first, as in a
stable sort, so every selection below is one exact function of its input.

Kernel K (``csrc/select.cu``, ``mvs_select``) computes the two selections
of this module on CUDA tensors:

- :func:`select_chunk`: the top ``kc`` of a chunk's (B, R) float32 scores
  (lane l is global index base + l below ``valid``, else ``none``), and
  their merge into a running pool of keys: the selection of the JAX
  package's ``_int_scan_pool`` (ann/int_index.py:124) and ``_scan_topk``
  (ann/flat_index.py:47);
- :func:`select_keys`: the top k of (B, W) keys, with their positions.

Each runs its plain PyTorch version (:func:`select_chunk_plain`,
:func:`select_keys_plain`: the packed keys and a stable descending sort)
for CPU tensors and launches kernel K for CUDA tensors, or raises.

``approx_max_k`` and the TPU's PartialReduce selector have no counterpart:
on the JAX CPU backend they reduce to exact top-k, and the port selects
exactly in every mode.
"""

from __future__ import annotations

import torch

from .. import _build

_LOW = (1 << 32) - 1
_HIGH = 1 << 32
# kernel K's block of the two-stage selection, and the largest k it sorts
# in shared memory (csrc/select.cu kBlock, kSmallK)
BLOCK = 128
SMALL_K = 2048


def _flip(x: torch.Tensor) -> torch.Tensor:
    """int32 float bits <-> order-preserving int32 (an involution)."""
    return x ^ ((x >> 31) & 0x7FFFFFFF)


def rank_keys(scores: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """float32 scores (..., n) and int64 indices in [0, 2^32) broadcastable
    to them -> int64 keys ordered by (score desc, index asc)."""
    bits = (scores + 0.0).view(torch.int32)          # -0.0 -> +0.0
    return _flip(bits).to(torch.int64) * _HIGH + (_LOW - index)


def key_scores(keys: torch.Tensor) -> torch.Tensor:
    return _flip((keys >> 32).to(torch.int32)).view(torch.float32)


def key_index(keys: torch.Tensor) -> torch.Tensor:
    return _LOW - (keys & _LOW)


def _top(keys: torch.Tensor, k: int):
    """The k best keys of each row, best first, equal keys in position
    order -> (keys, positions)."""
    top, pos = torch.sort(keys, dim=1, descending=True, stable=True)
    return top[:, :k], pos[:, :k]


def select_keys_plain(keys: torch.Tensor, k: int):
    """Plain PyTorch version of :func:`select_keys`."""
    return _top(keys, min(k, keys.shape[1]))


def select_chunk_plain(scores: torch.Tensor, base: int, valid: int,
                       none: int, kc: int, best: torch.Tensor, pool: int):
    """Plain PyTorch version of :func:`select_chunk`."""
    lane = torch.arange(scores.shape[1], device=scores.device)
    index = torch.where(lane < valid, base + lane, none)
    keys, lanes = _top(rank_keys(scores, index), kc)
    merged, pos = _top(torch.cat([best, keys], dim=1),
                       min(pool, best.shape[1] + kc))
    return keys, lanes, merged, pos


def _two_stage(kc: int, width: int) -> bool:
    """Kernel K's choice by shape: the two-stage selection over 128-lane
    block maxima when it cuts blocks (kc below the row's block count) and
    its chosen blocks fit the row CTA's shared memory; else every lane of
    the row is a candidate."""
    return kc < -(-width // BLOCK) and kc <= SMALL_K


def _launch(rows: torch.Tensor, kc: int, base: int = 0, valid: int = 0,
            none: int = 0, best: torch.Tensor | None = None,
            pool: int = 0):
    """Kernel K on rows ((B, W) float32 scores or int64 keys, unit stride
    along W) -> (keys (B, kc), lanes (B, kc), merged (B, wm), positions
    (B, wm)); no merge (wm = 0) without ``best``."""
    if rows.ndim != 2 or rows.dtype not in (torch.float32, torch.int64):
        raise ValueError("kernel K takes a 2-D float32 score or int64 key "
                         f"tensor (got {rows.dtype}, {rows.ndim}-D)")
    B, W = rows.shape
    if W and (rows.stride(1) != 1 or rows.stride(0) < W):
        raise ValueError("kernel K reads rows of unit stride")
    if W >= 1 << 31:
        raise ValueError(f"{W} lanes a row: kernel K takes fewer than 2^31")
    if not 1 <= kc <= W:
        raise ValueError(f"kc={kc} outside [1, {W}]")
    for name, v in (("base", base), ("none", none)):
        if not 0 <= v < _HIGH:
            raise ValueError(f"{name}={v} outside [0, 2^32)")
    if base + min(max(valid, 0), W) > _HIGH:
        raise ValueError("indices base + lane must stay below 2^32")
    dev = rows.device
    i64 = dict(dtype=torch.int64, device=dev)
    w0 = wm = 0
    if best is not None:
        if best.dtype != torch.int64 or best.ndim != 2 \
                or best.shape[0] != B or best.device != dev:
            raise ValueError("best must be (B, W0) int64 keys on the "
                             "rows' device")
        best = best.contiguous()
        w0 = best.shape[1]
        wm = min(pool, w0 + kc)
        if wm < 1:
            raise ValueError(f"pool={pool} keeps no key")
    out_key = torch.empty((B, kc), **i64)
    out_lane = torch.empty((B, kc), **i64)
    m_key = torch.empty((B, wm), **i64)
    m_pos = torch.empty((B, wm), **i64)
    if B == 0:
        return out_key, out_lane, m_key, m_pos
    bm = torch.empty((B, -(-W // BLOCK)), **i64) if _two_stage(kc, W) \
        else None
    big = kc > SMALL_K
    scratch_key = torch.empty((B, 2, kc), **i64) if big else None
    scratch_lane = torch.empty((B, 2, kc), dtype=torch.int32, device=dev) \
        if big else None
    scores = rows if rows.dtype == torch.float32 else None
    keys = rows if rows.dtype == torch.int64 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_select(
            ptr(scores), ptr(keys), rows.stride(0), B, W, base,
            max(0, min(valid, W)), none, kc, ptr(bm), ptr(scratch_key),
            ptr(scratch_lane), out_key.data_ptr(), out_lane.data_ptr(),
            ptr(best), w0, wm, ptr(m_key) if wm else None,
            ptr(m_pos) if wm else None, stream)
    _build.check(err, "select kernel")
    _build.count_launch("select")
    return out_key, out_lane, m_key, m_pos


def select_keys(keys: torch.Tensor, k: int):
    """(B, W) int64 keys -> (the min(k, W) best keys of each row (B, kk),
    best first, equal keys in position order; their positions (B, kk)
    int64)."""
    kk = min(k, keys.shape[1])
    if keys.device.type == "cpu":
        return select_keys_plain(keys, k)
    if kk <= 0:
        return keys[:, :0], torch.empty((keys.shape[0], 0),
                                        dtype=torch.int64, device=keys.device)
    top, pos, _, _ = _launch(keys, kk)
    return top, pos


def select_chunk(scores: torch.Tensor, base: int, valid: int, none: int,
                 kc: int, best: torch.Tensor, pool: int):
    """One chunk's selection and its merge into a running pool.

    scores: (B, R) float32 (unit stride along R); lane l carries the index
    base + l when l < valid, else ``none`` (every index below 2^32). best:
    (B, W0) int64 keys sorted best first, the previous call's merged keys
    (W0 = 0 on the first chunk). 1 <= kc <= R.

    -> (keys (B, kc) int64: the chunk's kc best keys, best first; lanes (B,
    kc) int64: their lanes; merged (B, min(pool, W0 + kc)) int64: the best
    of cat([best, keys]); positions (B, min(pool, W0 + kc)) int64: where
    each merged key sits in that concatenation)."""
    if scores.device.type == "cpu":
        return select_chunk_plain(scores, base, valid, none, kc, best, pool)
    return _launch(scores, kc, base, valid, none, best, pool)
