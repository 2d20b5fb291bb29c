"""splitmix64 finalizer on torch int64 — the seeded sign generator of the
sketch (reference src/random_projection.cpp:13-17).

Plain uint64 arithmetic on int64 tensors: two's-complement ``+`` and ``*``
wrap exactly like uint64, and ``^`` is bitwise; only ``>>`` differs (it is
arithmetic on int64), so a logical shift masks the sign-extended bits off.
torch's uint64 dtype is not used: it has no ``+`` or ``>>`` on the CPU.
Hash values >= 2^63 enter as their int64 bit pattern
(``np.uint64 -> .view(np.int64)``).
"""

from __future__ import annotations

import torch


def _signed(u: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


GOLDEN = _signed(0x9E3779B97F4A7C15)
MIX1 = _signed(0xBF58476D1CE4E5B9)
MIX2 = _signed(0x94D049BB133111EB)


def logical_shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """uint64 ``x >> k`` (0 < k < 64) on int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (including the += GOLDEN) of int64 bit patterns;
    bit-exact with the JAX package's splitmix64_np."""
    x = x + GOLDEN
    x = (x ^ logical_shift_right(x, 30)) * MIX1
    x = (x ^ logical_shift_right(x, 27)) * MIX2
    return x ^ logical_shift_right(x, 31)
