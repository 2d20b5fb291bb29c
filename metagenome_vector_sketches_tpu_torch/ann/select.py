"""Exact top-k selection with the JAX package's tie order.

``jax.lax.top_k`` keeps the lowest index among equal scores, and the JAX
engines depend on it for pool membership and for the ranked prefixes that
the adaptive search slices. ``torch.topk`` promises nothing about ties (on
CUDA in particular). So every (float32 score, index) pair is packed into
one int64 key that orders as (score descending, index ascending): the
score's bits mapped to an order-preserving int32 in the high word, the
complement of the index in the low word. Keys are distinct for distinct
indices, so ``torch.topk`` over keys is exact and deterministic on every
device, and score and index decode from the key without a gather. -0.0
ranks as +0.0, its equal.

``approx_max_k`` and the TPU's PartialReduce selector have no counterpart:
on the JAX CPU backend they reduce to exact top-k, and the port selects
exactly in every mode.
"""

from __future__ import annotations

import torch

_LOW = (1 << 32) - 1
_HIGH = 1 << 32


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


def merge_topk(best: torch.Tensor, keys: torch.Tensor, k: int):
    """Running top-k merge of key rows: -> (top keys (B, <= k) in
    descending order, their positions in cat([best, keys], 1))."""
    both = torch.cat([best, keys], dim=1)
    return torch.topk(both, min(k, both.shape[1]), dim=1)
