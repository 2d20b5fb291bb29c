"""The yardstick of the port's kernels: the card's published peaks and the
operations and bytes each kernel's inputs need.

Peaks: NVIDIA H100 SXM (data sheet, dense, at the full 700 W): int8 tensor
cores 1,979 TOP/s, float32 outside the tensor cores 67 TFLOP/s (kernel X's
integer multiply-adds are counted against it), HBM 3.35 TB/s; kernel P's
issue rate is 4 schedulers x 32 lanes x 132 SMs at the 1,980 MHz boost
clock. A bound is the larger of operations at the peak and bytes at the
HBM rate, with each input byte read once and each output byte written once.
A roofline share is the bound over the measured device time, in percent.

The kernels (``metagenome_vector_sketches_tpu_torch/csrc``):

- APPEND (``count.cu`` ``mvs_append``): the sweep with survivor compaction;
  2 * P * d operations a pair of rows, P = L (L + 1) / 2 Karatsuba planes;
- COUNT (``count.cu`` ``mvs_count``): the two-phase counts sweep, as APPEND;
- SCORE (``sweep.cu`` ``mvs_scan``): the int8 search's scan; bytes: the
  plane stack, the query planes, the float32 scores;
- K (``select.cu`` ``mvs_select``): top-k selection; bytes: the scores once;
- X (``partials.cu`` ``mvs_partials``): exact limb-pair partials;
  2 * L^2 * d_pad operations a pair;
- P (``projection.cu`` ``mvs_project``): 22 SASS instructions of splitmix64
  a (hash, 64-lane block);
- G (``sweep.cu`` ``mvs_gram``): the MinHash Gram, 2 ops a multiply-add.
"""

from __future__ import annotations

INT8_PEAK = 1979e12
CORE_PEAK = 67e12
HBM_RATE = 3.35e12
ISSUE_RATE = 4 * 32 * 132 * 1980e6
SPLITMIX_SASS = 22


def bound_s(ops: float = 0.0, peak: float = INT8_PEAK,
            nbytes: float = 0.0) -> float:
    """The least time the card could take: ops at ``peak`` or nbytes at
    the HBM rate, whichever is longer."""
    return max(ops / peak, nbytes / HBM_RATE)


def share_pct(bound: float, measured: float) -> float | None:
    """Roofline share in percent; None when nothing was measured."""
    if not measured or measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured


def num_planes(L: int) -> int:
    return L * (L + 1) // 2


def sweep_ops(pairs: float, P: int, d: int) -> float:
    """APPEND or COUNT: 2 * P * d operations a pair."""
    return 2.0 * P * d * pairs


def append_bound_s(pairs: float, P: int, d: int) -> float:
    return bound_s(sweep_ops(pairs, P, d), INT8_PEAK)


count_bound_s = append_bound_s


def shard_pairs(rows: int, n: int) -> int:
    """Unordered pairs a fused shard of ``rows`` rows of an n-row db needs:
    its own triangle with the diagonal, and every row outside it."""
    return rows * (rows + 1) // 2 + rows * (n - rows)


def score_bytes(P: int, rows: int, d: int, queries: int) -> float:
    """SCORE over ``rows`` db rows for ``queries`` queries: the int8 plane
    stack and the query planes read once, the float32 scores written."""
    return float(P * rows * d + P * queries * d + 4 * queries * rows)


def score_bound_s(P: int, rows: int, d: int, queries: int) -> float:
    return bound_s(2.0 * P * d * rows * queries, INT8_PEAK,
                   score_bytes(P, rows, d, queries))


def select_bound_s(queries: int, rows: int) -> float:
    """K: the (queries, rows) float32 scores read once."""
    return bound_s(nbytes=4.0 * queries * rows)


def partials_bound_s(pairs: int, L: int, d_pad: int, rows: int) -> float:
    """X: its multiply-adds, or the distinct rows' limb bytes, the pairs
    and the partials."""
    return bound_s(2.0 * pairs * L * L * d_pad, CORE_PEAK,
                   rows * L * d_pad + 8 * pairs
                   + 4 * pairs * num_planes(L))


def projection_bound_s(hashes: int, sets: int, d: int) -> float:
    """P: splitmix64's instructions at the issue rate, or the hashes and
    offsets in and the (sets, d) int32 lanes out."""
    blocks = (d + 63) // 64
    return bound_s(SPLITMIX_SASS * hashes * blocks, ISSUE_RATE,
                   8 * hashes + 8 * (sets + 1) + 4 * sets * d)


def gram_bound_s(n: int, width: int, blocks: int) -> float:
    """G: 128 x 128 output blocks of an (n, width) int8 incidence, 2 ops a
    multiply-add; bytes: the incidence in, the int32 blocks read and
    written."""
    return bound_s(2.0 * 128 * 128 * blocks * width, INT8_PEAK,
                   n * width + 2 * 4 * 128 * 128 * blocks)
