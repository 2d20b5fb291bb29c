"""Cases of kernel X's retention epilogue (ops.pairwise.pair_keep) and the
host path it replaced in the fused engine: kernel X's partials, the int64
combine of pairwise_math.combine_plane_partials, the host finalize's range
filter and exact test (matrix.compute finalize_dots) and the resident
engine's mirror selection. numpy and torch only: the GPU tests import it
too.

Each case is a db of ``TOTAL`` rows in planes of ``ROWS`` (the rows past
TOTAL are zero padding, as on the card), a shard [BEGIN, END) that starts
and ends inside a tile of ``TILE`` (twins on that grid), random candidate
pairs, and adversarial pairs on rows of their own whose squared norms are
set so that the test lands exactly where the case asks.
"""

import numpy as np
import torch

from metagenome_vector_sketches_tpu_torch.ops import pairwise as pw
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm

D = 200
TOTAL, ROWS = 300, 320
TILE = 32
BEGIN, END = 70, 230                     # neither on a tile edge
TWINS = (TILE, BEGIN // TILE, (END - 1) // TILE + 1)
MAX_ABS = {1: 100, 2: 3000, 3: 30000}
CASES = ("random", "on_threshold", "negative_dots", "int16_rounding",
         "tile_edges", "unaligned_begin", "padding_columns", "two_operands")
# rows of the adversarial pairs: a in the shard, b outside it (one pair a
# row, so each pair's threshold is its own)
ADV_A = range(100, 200)
ADV_B = range(240, 300)


def _quotient(dot: int, d: int, int16: bool) -> float:
    """The float64 value the reference compares with the threshold."""
    if int16:
        return float(np.float64(dot) / np.float64(d))
    q = abs(dot) // d
    return float(q if dot >= 0 else -q)


def _norm_sum_for(target: float):
    """A float64 s with fl(0.05 * s) == target, or None."""
    s0 = np.float64(target) / np.float64(0.05)
    for direction in (np.inf, -np.inf):
        s = s0
        for _ in range(256):
            if np.float64(0.05) * s == np.float64(target):
                return float(s)
            s = np.nextafter(s, direction)
    return None


def _planes(V: np.ndarray, L: int) -> torch.Tensor:
    t = torch.from_numpy(V.astype(np.int32))
    planes = torch.zeros((pm.num_planes(L), len(V), pw.pad_dim(V.shape[1])),
                         dtype=torch.int8)
    pw.planes_update(planes, pw.decompose_limbs(t, L), 0)
    return planes


def make_case(name: str, int16: bool, L: int, seed: int = 0,
              n_random: int = 3000) -> dict:
    """-> the operands of pair_keep for case ``name`` on the CPU: planes,
    rc, L, ns (a float64 numpy array of TOTAL rows), the Retention fields,
    row_base, col_base, planes_j, twins, and the adversarial pairs
    (a, b, dot, whether the reference keeps it)."""
    rng = np.random.default_rng(seed)
    m = MAX_ABS[L]
    V = np.zeros((ROWS, D), dtype=np.int64)
    V[:TOTAL] = rng.integers(-m, m + 1, size=(TOTAL, D))
    V[10:30] = V[9] + rng.integers(-3, 4, size=(20, D))     # near twins
    V[40:50] = -V[39] + rng.integers(-3, 4, size=(10, D))   # negative dots
    V[:TOTAL] = np.clip(V[:TOTAL], -m, m)
    if name == "negative_dots":
        for a, b in zip(ADV_A, ADV_B):
            V[b] = np.clip(-V[a] + rng.integers(-40, 41, size=D), -m, m)
    cand = np.stack([rng.integers(0, ROWS, n_random),
                     rng.integers(0, ROWS, n_random)], 1)
    if name == "tile_edges":
        edges = sorted({e + k for e in range(0, ROWS, TILE) for k in (-1, 0)
                        if 0 <= e + k < ROWS})
        cand = np.concatenate([cand, [(r, c) for r in edges for c in edges]])
    if name == "unaligned_begin":
        rows = [BEGIN - 1, BEGIN, BEGIN + 1, END - 1, END, END + 1]
        cand = np.concatenate([cand, [(r, c) for r in rows
                                      for c in range(0, ROWS, 7)]])
    if name == "padding_columns":
        cand = np.concatenate([cand, [(r, c) for r in range(BEGIN, END, 3)
                                      for c in range(TOTAL - 2, ROWS)]])
    dots = np.einsum("kd,kd->k", V[cand[:, 0]], V[cand[:, 1]])
    # squared norms that put the threshold near the typical |dot| / d
    scale = max(1.0, float(np.std(dots)) / D)
    ns = rng.uniform(0, 20 * scale, TOTAL)
    adv = []
    if name in ("on_threshold", "negative_dots", "int16_rounding"):
        for k, (a, b) in enumerate(zip(ADV_A, ADV_B)):
            dot = int(V[a] @ V[b])
            q = _quotient(dot, D, int16)
            if name == "int16_rounding":
                # the double quotient rounded down: the exact quotient lies
                # above it, the test on the double does not keep the pair
                from fractions import Fraction
                if not Fraction(dot, D) > Fraction(q):
                    continue
                target = q
            elif name == "negative_dots":
                # between the truncated and the floored quotient
                target = q - 0.5 if not int16 else q
            else:
                # on the quotient (not kept) or one ulp below it (kept)
                target = q if k % 2 else float(np.nextafter(q, -np.inf))
            s = _norm_sum_for(target)
            if s is None:
                continue
            ns[a], ns[b] = s, 0.0
            adv.append((a, b, dot, q > target))
        assert len(adv) >= 8, (name, len(adv))
        cand = np.concatenate([cand, [(a, b) for a, b, _, _ in adv],
                               [(b, a) for a, b, _, _ in adv]])
    # distinct pairs, none of them the twin of another (the engine sweeps
    # no tile below the diagonal inside the shard's row tiles)
    cand = np.unique(cand, axis=0)
    rt, ct = cand[:, 0] // TILE, cand[:, 1] // TILE
    cand = cand[~((rt > ct) & (rt >= TWINS[1]) & (rt < TWINS[2]))]
    case = dict(planes=_planes(V, L), rc=torch.from_numpy(
        cand.astype(np.int32)).contiguous(), L=L, ns=ns, d=D, int16=int16,
        begin_row=BEGIN, end_row=END, total=TOTAL, row_base=0, col_base=0,
        planes_j=None, twins=TWINS, adversarial=adv)
    if name == "two_operands":
        # the streaming engine's operands: a row group and a window, each
        # with its own first global row, and no twins
        rg, ws = 64, 160
        case.update(planes=_planes(V[rg:rg + 192], L),
                    planes_j=_planes(V[ws:], L), row_base=rg, col_base=ws,
                    twins=None)
        c2 = np.unique(np.stack([rng.integers(0, 192, n_random),
                                 rng.integers(0, ROWS - ws, n_random)], 1),
                       axis=0)
        case["rc"] = torch.from_numpy(c2.astype(np.int32)).contiguous()
    return case


def retention(case: dict, device="cpu") -> pw.Retention:
    return pw.Retention(torch.from_numpy(case["ns"]).to(device), case["d"],
                        case["int16"], case["begin_row"], case["end_row"],
                        case["total"])


def keep(case: dict, cap: int, device="cpu"):
    """pair_keep on ``device`` -> (its kept set {(row, col, dot)}, kept,
    emitted, out of range)."""
    to = (lambda t: None if t is None else t.to(device))
    out, counters = pw.pair_keep(
        to(case["planes"]), to(case["rc"]), case["L"],
        retention(case, device), cap, to(case["planes_j"]),
        case["row_base"], case["col_base"], case["twins"])
    counts = counters.cpu().numpy()
    (r, c, dots), nbytes = pw.read_kept(out, counts)
    assert nbytes == len(r) * pw.KEPT_BYTES + pw.COUNTER_BYTES
    got = set(zip(r.tolist(), c.tolist(), dots.tolist()))
    assert len(got) == len(r)
    return got, int(counts[0]), int(counts[1]), int(counts[2])


def host_path(case: dict):
    """The host path of the fused engine before kernel X tested on the
    card -> (kept set {(row, col, dot)}, candidates, emitted)."""
    rc = case["rc"]
    parts = pw.pair_partials_plain(case["planes"], rc, case["L"],
                                   case["planes_j"]).numpy()
    dots = pm.combine_plane_partials(parts.T, case["L"])
    r = rc[:, 0].numpy().astype(np.int64) + case["row_base"]
    c = rc[:, 1].numpy().astype(np.int64) + case["col_base"]
    ns, d = case["ns"], case["d"]
    exact_filter = pm.exact_filter_int16 if case["int16"] \
        else pm.exact_filter_int32
    kept, emitted = set(), 0

    def finalize_dots(rg, cg, dg):
        nonlocal emitted
        m = (rg >= case["begin_row"]) & (rg < case["end_row"]) \
            & (cg < case["total"])
        rg, cg, dg = rg[m], cg[m], dg[m]
        emitted += len(rg)
        if len(rg):
            k = exact_filter(dg, 0.05 * (ns[rg] + ns[cg]), d)
            kept.update(zip(rg[k].tolist(), cg[k].tolist(), dg[k].tolist()))

    finalize_dots(r, c, dots)
    if case["twins"] is not None:
        tile, rt0, rt1 = case["twins"]
        ct = c // tile
        m = (ct > r // tile) & (ct >= rt0) & (ct < rt1)
        finalize_dots(c[m], r[m], dots[m])
    return kept, len(r), emitted
