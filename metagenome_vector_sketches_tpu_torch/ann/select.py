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
# kernel K's block of the two-stage selection, the largest kc of its row
# stage (csrc/select.cu kBlock, kSmallK), and the widest row its row regime
# takes
BLOCK = 128
SMALL_K = 2048
ROW_WIDTH = 16384
# kernel K's regimes, in the order of csrc/select.cu's enum Regime
REGIMES = ("two_stage", "row", "radix", "full")


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
    """The two-stage selection over 128-lane block maxima: when it cuts
    blocks (kc below the row's block count) and its chosen blocks fit the
    row stage's shared memory."""
    return kc < -(-width // BLOCK) and kc <= SMALL_K


def regime(kc: int, width: int) -> str:
    """Kernel K's regime, chosen by shape (csrc/select.cu's header note):
    ``two_stage`` (one launch: block maxima, then each row's last CTA
    selects); ``row`` (one CTA a row over every lane: kc <= SMALL_K on rows
    of at most ROW_WIDTH lanes that the block maxima would not cut);
    ``full`` (kc = width: the grid-wide sort of every lane); ``radix`` (any
    other kc: a multi-CTA radix select, then the grid-wide sort)."""
    if _two_stage(kc, width):
        return "two_stage"
    if kc <= SMALL_K and width <= ROW_WIDTH:
        return "row"
    return "full" if kc == width else "radix"


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
    # one allocation for each pair of outputs (keys and lanes; merged keys
    # and positions) and one for the kernel's workspace
    out = torch.empty((2, B, kc), dtype=torch.int64, device=dev)
    merged = torch.empty((2, B, wm), dtype=torch.int64, device=dev)
    if B == 0:
        return (*out.unbind(0), *merged.unbind(0))
    code = REGIMES.index(regime(kc, W))
    lib = _build.library()
    nbytes = lib.mvs_select_work_bytes(code, B, W, kc)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    o, m = out.data_ptr(), merged.data_ptr() if wm else None
    with _build.launch_stream(dev) as stream:
        err = lib.mvs_select(
            rows.data_ptr() if rows.dtype == torch.float32 else None,
            rows.data_ptr() if rows.dtype == torch.int64 else None,
            rows.stride(0), B, W, base, max(0, min(valid, W)), none, kc, code,
            work.data_ptr() if nbytes else None, o, o + 8 * B * kc, best.data_ptr() if w0 else None, w0,
            wm, m, m + 8 * B * wm if wm else None, stream)
    _build.check(err, "select kernel")
    _build.count_launch("select")
    return (*out.unbind(0), *merged.unbind(0))


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
