"""Framework-neutral (numpy-only) half of the pairwise math.

A copy of the numpy functions of ``metagenome_vector_sketches_tpu.ops.
pairwise`` (the overflow guard of ``exact_dots_host`` raises ValueError
where the original asserts), which cannot be imported here because that
module imports JAX.
``tests/test_torch_math.py`` holds every function equal to its twin.

Balanced base-128 limbs: v = sum_k limb_k * 2^(7k) with every limb in
[-64, 63] (for L > 1), so limb sums fit int8 and the Karatsuba combine
needs L(L+1)/2 plane products instead of L^2 (see ``plane_weights``).
"""

from __future__ import annotations

import numpy as np


def _balanced_top(v: int, L: int) -> int:
    """Top digit of the balanced base-128 decomposition of python int v."""
    cur = v
    for _ in range(L - 1):
        digit = ((cur + 64) % 128) - 64
        cur = (cur - digit) >> 7          # exact: cur - digit divisible by 128
    return cur


def _limbs_ok(max_abs: int, L: int) -> bool:
    if L == 1:
        # single limb: no cross sums, plain int8 range suffices
        return -128 <= -max_abs and max_abs <= 127
    # every limb (incl. top) must land in [-64, 63] so limb SUMS fit int8
    # (_balanced_top is monotone in v, so endpoints suffice)
    return -64 <= _balanced_top(-max_abs, L) and _balanced_top(max_abs, L) <= 63


def pick_limbs(max_abs: int) -> int:
    L = 1
    while not _limbs_ok(max_abs, L):
        L += 1
    return L


def check_exact_dot_range(d: int, max_abs: int) -> None:
    """Reject a database whose worst-case dot d*max_abs^2 could wrap the
    int64 exact combine (combine_plane_partials)."""
    if int(d) * (int(max_abs) ** 2) >= (1 << 62):
        raise ValueError(
            f"|components| up to {max_abs} at d={d} put the worst-case dot "
            f"d*max^2 = {int(d) * int(max_abs) ** 2:.3e} beyond the exact "
            "int64 range (2^62) — this database cannot be processed "
            "exactly")


def num_planes(L: int) -> int:
    return L * (L + 1) // 2


def limbs_from_planes(P: int) -> int:
    """Inverse of num_planes (planes count is 1, 3, 6, 10, ... for L=1,2,3,4)."""
    L = int((np.sqrt(8 * P + 1) - 1) / 2 + 0.5)
    assert num_planes(L) == P, f"not a plane count: {P}"
    return L


def plane_weights(L: int) -> np.ndarray:
    """float32 combine weights of the Karatsuba plane products.

    Plane order: the L limbs, then the sums limb_a+limb_b for a < b in
    lexicographic order. From
        dot = sum_k 2^{14k} P_kk + sum_{a<b} 2^{7(a+b)} (M_ab - P_aa - P_bb)
    the subtraction folds into the diagonal weights:
        w_diag(k)    = 2^{14k} - sum_{j != k} 2^{7(k+j)}
        w_pair(a,b)  = 2^{7(a+b)}
    Exact in float32 up to L=4; at L=5 a diagonal weight rounds, which
    required_slack_abs budgets.
    """
    w = [float(1 << (14 * k)) - sum(float(1 << (7 * (k + j)))
                                    for j in range(L) if j != k)
         for k in range(L)]
    w += [float(1 << (7 * (a + b))) for a in range(L) for b in range(a + 1, L)]
    return np.asarray(w, dtype=np.float32)


def plane_weights_int(L: int) -> np.ndarray:
    """int64 twin of plane_weights: ``plane_weights_int(L) @ S`` over the
    exact per-plane partial dots S_p is the exact int64 dot."""
    w = [(1 << (14 * k)) - sum(1 << (7 * (k + j))
                               for j in range(L) if j != k)
         for k in range(L)]
    w += [1 << (7 * (a + b)) for a in range(L) for b in range(a + 1, L)]
    return np.asarray(w, dtype=np.int64)


def decompose_limbs_host(v: np.ndarray, L: int) -> np.ndarray:
    """(n, d) int -> (L, n, d) int8 balanced limbs on the host. With
    t = cur + 64 the balanced digit is (t & 127) - 64 and the next limb is
    exactly t >> 7 (arithmetic), so each limb is three in-place passes."""
    t = v.astype(np.int32, copy=True)
    limbs = np.empty((L,) + v.shape, dtype=np.int8)
    for k in range(L - 1):
        np.add(t, 64, out=t)
        np.bitwise_and(t, 127, out=limbs[k], casting="unsafe")
        limbs[k] -= 64
        np.right_shift(t, 7, out=t)       # exact arithmetic shift of t
    limbs[L - 1] = t
    return limbs


# Retention-threshold slack of the float32 sweep. The exact host re-filter
# removes false positives, so the slack only has to bound the float32
# rounding of the plane combine against false NEGATIVES: the relative term
# covers ulp(dot)-scale error on large dots, the absolute term the combine
# noise floor on small ones. The engine certifies it per run
# (threshold_adjust) and widens or tightens the thresholds to match.
SLACK_REL = np.float32(1.0 - 1e-5)
SLACK_ABS = np.float32(16.0)


def plane_value_bounds(L: int, max_abs: int) -> list[int]:
    """Per-plane max |value| for components bounded by max_abs: low limbs
    hit +-64 regardless, the top limb is bounded by the balanced
    decomposition of +-max_abs, each sum plane by its two limbs' bounds."""
    if L == 1:
        return [min(max_abs, 128)]
    top = max(abs(_balanced_top(-max_abs, L)), abs(_balanced_top(max_abs, L)))
    m = [64] * (L - 1) + [top]
    return m + [m[a] + m[b] for a in range(L) for b in range(a + 1, L)]


def required_slack_abs(L: int, max_abs: int, d: int) -> float:
    """Certified bound on |approx_dot_f32 - exact dot| / d: each plane
    partial loses <= eps32*|P_p| in its float32 conversion and the P-term
    weighted accumulation adds <= (P-1)*eps32*sum_p |w_p|*d*m_p^2; one extra
    factor of margin on top, plus the float32 weight-quantisation term
    (nonzero from L = 5)."""
    L = int(L)
    w = np.abs(plane_weights(L)).astype(np.float64)
    m = np.asarray(plane_value_bounds(L, max_abs), dtype=np.float64)
    P = num_planes(L)
    eps = 2.0 ** -24
    total_mass = float(np.sum(w * m * m))  # per unit of d
    quant = np.abs(plane_weights(L).astype(np.float64)
                   - plane_weights_int(L).astype(np.float64))
    quant_mass = float(np.sum(quant * m * m))
    return (P + 1) * eps * total_mass + quant_mass


def threshold_adjust(L: int, max_abs: int, d: int) -> float:
    """Signed per-entry squared-norm adjustment of the sweep thresholds.
    The sweep compares approx/d > 0.05*(ti+tj)*REL - SLACK_ABS; adding a to
    every entry removes 0.1*a of absolute slack. Negative = widen (the
    certified combine error exceeds SLACK_ABS); positive = tighten the
    effective slack down to max(1.0, 2*required_slack_abs), so small-norm
    databases do not pass a constant fraction of all pairs to the exact
    finalize."""
    need = required_slack_abs(L, max_abs, d)
    target = max(1.0, min(2.0 * need, max(float(SLACK_ABS), need)))
    return (float(SLACK_ABS) - target) * 10.0


def combine_plane_partials(partials: np.ndarray, L: int) -> np.ndarray:
    """(L(L+1)/2, K) int32 partials -> (K,) exact int64 dots:
    dot = sum_a 2^(14a) D_aa + sum_{a<b} 2^(7(a+b)) (D_ab + D_ba).
    Exact while d * max_abs^2 < 2^62 (check_exact_dot_range)."""
    partials = partials.astype(np.int64)
    w = [1 << (14 * a) for a in range(L)]
    w += [1 << (7 * (a + b)) for a in range(L) for b in range(a + 1, L)]
    return np.asarray(w, dtype=np.int64) @ partials


def exact_dots_host(V: np.ndarray, rows: np.ndarray, cols: np.ndarray,
                    max_abs: int, chunk: int | None = None) -> np.ndarray:
    """Exact int64 dot products of V[rows] . V[cols] on host.

    float64 accumulation is exact while every partial sum stays an integer
    below 2^53 (d * max_abs^2 — true for any real sketch db, components are
    bounded by hash-set sizes); int64 accumulation covers the rest. Chunked
    so the two gathered float64 copies stay near 256 MB regardless of d."""
    d = V.shape[1]
    if chunk is None:
        chunk = max(1024, (256 << 20) // (16 * d))
    f64_ok = d * (max_abs ** 2) < (1 << 53)
    if not (f64_ok or d * (max_abs ** 2) < (1 << 62)):
        raise ValueError("dot would overflow int64")
    out = np.empty(len(rows), dtype=np.int64)
    dt = np.float64 if f64_ok else np.int64
    for s in range(0, len(rows), chunk):
        e = min(s + chunk, len(rows))
        gi = V[rows[s:e]].astype(dt)
        gj = V[cols[s:e]].astype(dt)
        out[s:e] = np.einsum("kd,kd->k", gi, gj).astype(np.int64)
    return out


def exact_filter_int32(dots: np.ndarray, thr: np.ndarray, d: int) -> np.ndarray:
    """Reference int32 retention: (dot / d) > 0.05*(ni+nj) with C++ int64
    truncating division (pairwise_comp_optimized.cpp:139-141)."""
    q = np.where(dots >= 0, dots // d, -((-dots) // d))
    return q.astype(np.float64) > thr


def exact_filter_int16(dots: np.ndarray, thr: np.ndarray, d: int) -> np.ndarray:
    """Reference int16 retention: double division
    (pairwise_comp_optimized_16bits.cpp:211-218)."""
    return dots.astype(np.float64) / d > thr
