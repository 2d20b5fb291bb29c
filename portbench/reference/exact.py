"""The plain reference of the matrix shard and of the search: exact dots of
the db's vectors, the upstream retention test and quantisation, and the
seeded +-1 projection of hash sets. Plain PyTorch and numpy; it imports
nothing of the program.

Upstream semantics (RolandFaure/metagenome_vector_sketches):

- vectors: lane n of d of a hash set is the sum over its hashes h of
  1 - 2 * bit_(n % 64)(splitmix64(h + 64 * (n // 64)))
  (src/random_projection.cpp);
- norms: vector_norms.txt holds ||v / sqrt(d)|| printed with 6 significant
  digits; the pairwise tools square the parsed text as |set|;
- retention of a pair (i, j): dot / d > 0.05 * (|i| + |j|), with the dot
  divided as a C++ int64 (truncated) for int32 dbs
  (pairwise_comp_optimized.cpp) and as a double for int16 dbs
  (pairwise_comp_optimized_16bits.cpp); self-pairs are kept;
- value: J = (dot / d) / (|i| + |j| - dot / d) in float64, clamped to
  [0, 1], stored as floor(255 J + 0.5).

``precision`` selects the arithmetic of the dots: "exact" (float64 on
integer inputs, exact while d * max|v|^2 < 2^53), or the controls:
"float32" (float32 products with TF32 off), "int16" and "int8" (every
component saturated to that type first).
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("exact", "float32", "int16", "int8")


# ---------------------------------------------------------------- limbs

def _balanced_top(v: int, L: int) -> int:
    cur = v
    for _ in range(L - 1):
        digit = ((cur + 64) % 128) - 64
        cur = (cur - digit) >> 7
    return cur


def limbs(max_abs: int) -> int:
    """Balanced base-128 limbs that hold components up to max_abs with every
    limb sum in int8 (one limb: plain int8)."""
    L = 1
    while True:
        if L == 1:
            if max_abs <= 127:
                return 1
        elif (-64 <= _balanced_top(-max_abs, L)
              and _balanced_top(max_abs, L) <= 63):
            return L
        L += 1


def planes(max_abs: int) -> int:
    L = limbs(max(1, max_abs))
    return L * (L + 1) // 2


# ---------------------------------------------------------------- projection

def _s(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


_GOLDEN, _MIX1, _MIX2 = (_s(0x9E3779B97F4A7C15), _s(0xBF58476D1CE4E5B9),
                         _s(0x94D049BB133111EB))


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (two's-complement + and *
    wrap as uint64 does)."""
    x = x + _GOLDEN
    x = (x ^ _lsr(x, 30)) * _MIX1
    x = (x ^ _lsr(x, 27)) * _MIX2
    return x ^ _lsr(x, 31)


def project(hashes: np.ndarray, offsets: np.ndarray, d: int,
            device) -> torch.Tensor:
    """CSR hash sets (uint64 values, int64 offsets) -> (B, d) int32 lanes on
    ``device``."""
    dev = torch.device(device)
    h = torch.from_numpy(np.ascontiguousarray(hashes).view(np.int64)).to(dev)
    o = torch.from_numpy(np.asarray(offsets, dtype=np.int64)).to(dev)
    B = len(offsets) - 1
    nb = (d + 63) // 64
    counts = o[1:] - o[:-1]
    set_id = torch.repeat_interleave(torch.arange(B, device=dev), counts)
    bitsum = torch.zeros(B, nb * 64, dtype=torch.int32, device=dev)
    blocks = torch.arange(nb, device=dev, dtype=torch.int64) * 64
    v = torch.arange(256, device=dev, dtype=torch.int32)
    lut = ((v[:, None] >> torch.arange(8, device=dev, dtype=torch.int32))
           & 1).to(torch.int32)
    step = max(1, (256 << 20) // (nb * 64 * 4)) if dev.type == "cuda" \
        else 4096
    for s in range(0, h.numel(), step):
        x = splitmix64(h[s:s + step, None] + blocks[None, :])
        bits = lut[x.contiguous().view(torch.uint8).to(torch.int64)]
        bitsum.index_add_(0, set_id[s:s + step],
                          bits.reshape(x.shape[0], nb * 64))
    return (counts.to(torch.int32)[:, None] - 2 * bitsum)[:, :d].contiguous()


# ---------------------------------------------------------------- dots

def operand(v: torch.Tensor, precision: str) -> torch.Tensor:
    """Integer vectors -> the floating operand of ``precision``'s dots."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    if precision == "int16":
        v = v.clamp(-32768, 32767)
    elif precision == "int8":
        v = v.clamp(-128, 127)
    return v.to(torch.float32 if precision == "float32" else torch.float64)


def dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(r, d) x (n, d) operands (:func:`operand`) -> (r, n) int64 dots on
    their device, with TF32 off."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.round(a @ b.T).to(torch.int64)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------------- retention

def retained(dot: torch.Tensor, thr: torch.Tensor, d: int,
             dtype: str) -> torch.Tensor:
    """The upstream retention test of int64 dots against thresholds
    0.05 * (|i| + |j|) of the text-parsed squared norms."""
    if dtype == "int16":
        return dot.to(torch.float64) / d > thr
    return torch.div(dot, d, rounding_mode="trunc").to(torch.float64) > thr


def quantised(dot: np.ndarray, ns_i, ns_j: np.ndarray, d: int) -> np.ndarray:
    inter = dot.astype(np.float64) / float(d)
    with np.errstate(divide="ignore", invalid="ignore"):
        jac = inter / (ns_i + ns_j - inter)
    jac = np.clip(np.nan_to_num(jac, nan=0.0), 0.0, 1.0)
    return np.floor(jac * 255.0 + 0.5).astype(np.int64)


def shard_rows(V: torch.Tensor, rows: np.ndarray, ns: np.ndarray, d: int,
               dtype: str, precision: str = "exact", chunk: int = 256):
    """Expected record of each of ``rows`` in its shard: a list of
    (columns int64, quantised Jaccards int64). V: the db's (N, d) integer
    vectors on the device that computes; ``chunk`` rows at a time, so the
    dots of a chunk against every column stay on the device."""
    rows = np.asarray(rows, dtype=np.int64)
    ns_dev = torch.from_numpy(np.asarray(ns, dtype=np.float64)).to(V.device)
    Vf = operand(V, precision)
    out = []
    for s in range(0, len(rows), chunk):
        part = torch.from_numpy(rows[s:s + chunk]).to(V.device)
        D = dots(Vf[part], Vf)
        keep = retained(D, 0.05 * (ns_dev[part][:, None] + ns_dev[None, :]),
                        d, dtype)
        k, c = torch.nonzero(keep, as_tuple=True)
        vals = D[k, c].cpu().numpy()
        k, c = k.cpu().numpy(), c.cpu().numpy()
        bounds = np.searchsorted(k, np.arange(len(part) + 1))
        for i, r in enumerate(rows[s:s + chunk]):
            cols = c[bounds[i]:bounds[i + 1]].astype(np.int64)
            out.append((cols, quantised(vals[bounds[i]:bounds[i + 1]],
                                        ns[r], ns[cols], d)))
        del D, keep
    return out
