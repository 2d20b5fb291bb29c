"""Monte-Carlo accuracy study of the Jaccard estimators.

Replicates src/compute_error_of_random_projections.py: the binomial surrogate
for random-projection vectors (:26-32 — a d-dim vector whose entries are
2*Binomial(n, 1/2) - n, matching the distribution of a +-1 projection of n
elements), the FracMinHash subsampling model (:166-169), RMSE + percentile
grids over (size1, size2, jaccard) (:263-316), and the error-vs-dimension
curve (:62-86). Vectorized over trials (the reference loops in Python);
plotting is optional and gated on matplotlib.
"""

from __future__ import annotations

import pickle

import numpy as np

DEFAULT_SIZES = [10_000, 30_000, 100_000, 300_000, 1_000_000, 3_000_000,
                 10_000_000, 30_000_000, 100_000_000, 300_000_000,
                 1_000_000_000, 3_000_000_000, 10_000_000_000,
                 30_000_000_000, 100_000_000_000]
DEFAULT_JACCARDS = [0, 0.01, 0.03, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7,
                    0.8, 0.9, 0.99]


def projection_like_vectors(dimension: int, n_elements: np.ndarray,
                            rng: np.random.Generator) -> np.ndarray:
    """(T,) element counts -> (T, d) float32 surrogate projection vectors
    (reference get_me_a_random_projection_like_vector, :26-32)."""
    vec = rng.binomial(n_elements[:, None], 0.5, size=(len(n_elements), dimension))
    vec = 2 * vec - n_elements[:, None]
    return (vec / np.sqrt(dimension)).astype(np.float32)


def simulate_cell(size1: int, size2: int, jaccard: float, dimension: int = 2048,
                  sampling: int = 1000, n_trials: int = 500,
                  rng: np.random.Generator | None = None):
    """One (size1, size2, J) grid cell -> dict with both estimators' RMSE and
    the random-projection error percentiles (reference :278-311)."""
    rng = rng or np.random.default_rng(0)
    inter = int((size1 + size2) * jaccard / (1 + jaccard))
    if inter > size1 or inter > size2:
        return None
    s_int = rng.binomial(inter, 1.0 / sampling, size=n_trials)
    s_d1 = rng.binomial(size1 - inter, 1.0 / sampling, size=n_trials)
    s_d2 = rng.binomial(size2 - inter, 1.0 / sampling, size=n_trials)
    denom = s_int + s_d1 + s_d2
    with np.errstate(invalid="ignore", divide="ignore"):
        est_fmh = np.where(denom > 0, s_int / denom, 0.0)
    v_int = projection_like_vectors(dimension, s_int, rng)
    v_d1 = projection_like_vectors(dimension, s_d1, rng)
    v_d2 = projection_like_vectors(dimension, s_d2, rng)
    v1 = v_int + v_d1
    v2 = v_int + v_d2
    dot = np.einsum("ij,ij->i", v1, v2, dtype=np.float64)
    n1 = np.einsum("ij,ij->i", v1, v1, dtype=np.float64)
    n2 = np.einsum("ij,ij->i", v2, v2, dtype=np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        est_rp = np.where(n1 + n2 - dot != 0, dot / (n1 + n2 - dot), 0.0)
    err_rp = est_rp - jaccard
    err_sorted = np.sort(err_rp)
    T = n_trials
    return {
        "rmse_fmh": float(np.sqrt(np.mean((est_fmh - jaccard) ** 2))),
        "rmse_rp": float(np.sqrt(np.mean(err_rp ** 2))),
        # same index math as the reference (:303-310) but with every index
        # clamped (the reference only guards the p1 slot, so small n_trials
        # silently report the MAX error as p5/p50 via negative indexing);
        # the last slot is the max, which the reference labels "99th"
        "percentiles": (float(err_sorted[max(0, T // 100 - 1)]),
                        float(err_sorted[max(0, 5 * T // 100 - 1)]),
                        float(err_sorted[max(0, 50 * T // 100 - 1)]),
                        float(err_sorted[max(0, 95 * T // 100 - 1)]),
                        float(err_sorted[-1])),
    }


def compute_error_for_all_points_in_space(sizes=None, jaccards=None,
                                          dimension: int = 2048,
                                          sampling: int = 1000,
                                          n_trials: int = 500,
                                          out_pickle: str | None = "all_errors.pkl",
                                          seed: int = 0, verbose: bool = True):
    """Full grid (reference :263-316). Returns {(s1, s2, J): (rmse, p1, p5,
    p50, p95, p99)} and optionally pickles it like the reference."""
    sizes = sizes if sizes is not None else DEFAULT_SIZES
    jaccards = jaccards if jaccards is not None else DEFAULT_JACCARDS
    rng = np.random.default_rng(seed)
    all_errors = {}
    total = len(sizes) ** 2 * len(jaccards)
    for size1 in sizes:
        for size2 in sizes:
            for j in jaccards:
                cell = simulate_cell(size1, size2, j, dimension, sampling,
                                     n_trials, rng)
                if cell is None:
                    continue
                all_errors[(size1, size2, j)] = (cell["rmse_rp"],) + cell["percentiles"]
                if verbose:
                    print(f"completed {len(all_errors)} out of {total}")
    if out_pickle:
        with open(out_pickle, "wb") as f:
            pickle.dump(all_errors, f)
    return all_errors


def error_vs_dimension(n_elements: int = 2000, n_sets: int = 5000,
                       dimensions=(256, 512, 1024, 2048, 4096, 8192, 16384),
                       seed: int = 0, verbose: bool = True):
    """The error-parameter-vs-d curve (reference plot_error_random_proj,
    :62-86). Returns [(dimension, relative_error), ...]."""
    rng = np.random.default_rng(seed)
    out = []
    for d in dimensions:
        counts = np.full(n_sets, n_elements)
        proj = projection_like_vectors(d, counts, rng)
        dots = np.einsum("ij,ij->i", proj[0::2][: n_sets // 2],
                         proj[1::2][: n_sets // 2], dtype=np.float64)
        s = np.sort(dots)
        max_error = (s[-10] - s[10]) / 2
        rel = max_error / n_elements
        out.append((d, float(rel)))
        if verbose:
            print(f"dimension={d}, Max error: {max_error}, Relative error: {rel}")
    return out


def plot_heatmaps(all_errors: dict, dimension: int = 2048,
                  sampling: int = 1000, show: bool = True, save_prefix=None):
    """RMSE heatmaps per size1 (reference :323-366)."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    unique_size1 = sorted({k[0] for k in all_errors})
    for target in unique_size1:
        entries = [(s2, j, v[0]) for (s1, s2, j), v in all_errors.items()
                   if s1 == target]
        if not entries:
            continue
        u2 = sorted({e[0] for e in entries})
        uj = sorted({e[1] for e in entries})
        mat = np.full((len(uj), len(u2)), np.nan)
        for s2, j, rmse in entries:
            mat[uj.index(j), u2.index(s2)] = rmse
        plt.figure(figsize=(12, 8))
        plt.imshow(mat, aspect="auto", cmap="viridis", origin="lower")
        plt.colorbar(label="RMSE")
        plt.xticks(range(len(u2)), [f"{s:.0e}" for s in u2], rotation=45,
                   ha="right")
        plt.yticks(range(len(uj)), [f"{j:.2f}" for j in uj])
        plt.xlabel("Size2")
        plt.ylabel("Jaccard")
        plt.title(f"RMSE Heatmap for Size1 = {target:,}\n"
                  f"Dimension={dimension}, Sampling={1/sampling}")
        plt.tight_layout()
        if save_prefix:
            plt.savefig(f"{save_prefix}_size1_{target}.png")
        if show:
            plt.show()
        plt.close()
