"""PCA cluster visualization of a db folder (reference src/clusters.py).

Loads vectors.bin, filters accessions with norm >= 10, PCA-projects and
scatter-plots with accession labels; optionally overlays big_vectors.bin
(:62-79). PCA uses sklearn when available, else a numpy SVD fallback.

Two deliberate fixes of reference defects (src/clusters.py:76-85): the
reference scatters the big_vectors overlay BEFORE plt.figure(), so the
overlay lands on a throwaway implicit figure and never appears in the
shown/saved plot; and it plots components (1, 2) while labelling them
with the variance ratios of components (0, 1) ("First Two Axes"). Here
the overlay shares the main figure and the plotted components are
(0, 1), matching the labels/title.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.dbfolder import DbFolder


def load_vectors(folder: str):
    """(vectors, names) with the norm >= 10 filter (reference :8-48).
    Honors dtype.txt via DbFolder (the reference reads int32
    unconditionally, silently misparsing int16 db folders)."""
    db = DbFolder(folder)
    vectors = db.load_vectors()
    names, norms = db.names_and_norms()
    mask = norms >= 10
    return vectors[mask], np.array(names)[mask]


class _NumpyPCA:
    """Minimal PCA via SVD: fit_transform / transform / explained ratios."""

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = x.astype(np.float64)
        self.mean_ = x.mean(axis=0)
        xc = x - self.mean_
        u, s, vt = np.linalg.svd(xc, full_matrices=False)
        self.components_ = vt
        var = s ** 2 / max(1, len(x) - 1)
        self.explained_variance_ratio_ = var / var.sum()
        return u * s

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x.astype(np.float64) - self.mean_) @ self.components_.T


def make_pca():
    try:
        from sklearn.decomposition import PCA
        return PCA()
    except Exception:
        return _NumpyPCA()


def plot_clusters(folder: str, show: bool = True, save: str | None = None):
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vectors, names = load_vectors(folder)
    print("vectors loaded, I have ", len(vectors), " vectors")
    pca = make_pca()
    pca_result = pca.fit_transform(vectors)
    print("pca computed")

    plt.figure(figsize=(8, 6))

    big_path = os.path.join(folder, "big_vectors.bin")
    if os.path.exists(big_path):
        dim = vectors.shape[1]
        itemsize = vectors.dtype.itemsize
        count = min(500000, os.path.getsize(big_path) // (itemsize * dim))
        big = np.fromfile(big_path, dtype=vectors.dtype,
                          count=count * dim).reshape(-1, dim)
        big_pca = pca.transform(big)
        # same figure, same components as the main scatter (see module
        # docstring for the reference defect this fixes)
        plt.scatter(big_pca[:, 0], big_pca[:, 1], alpha=0.3, color="red",
                    label="big_vectors")
        plt.legend()
    else:
        print("big_vectors.bin not found, skipping projection.")

    # a tiny filtered sample can yield < 2 components — plot what exists
    n_comp = pca_result.shape[1] if pca_result.ndim == 2 else 1
    cx, cy = 0, min(1, n_comp - 1)
    plt.scatter(pca_result[:, cx], pca_result[:, cy], alpha=0.7)
    for i, name in enumerate(names):
        plt.annotate(name, (pca_result[i, cx], pca_result[i, cy]),
                     fontsize=8, alpha=0.7)
    evr = pca.explained_variance_ratio_
    plt.xlabel(f"PCA Axis 1 ({evr[cx]*100:.2f}% variance)")
    plt.ylabel(f"PCA Axis 2 ({evr[cy]*100:.2f}% variance)")
    plt.title("PCA: First Two Axes")
    plt.grid(True)
    plt.tight_layout()
    if save:
        plt.savefig(save)
    if show:
        plt.show()
    print("Explained variance ratio:")
    print(evr)
    return pca_result, names


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print(f"Usage: clusters <folder>")
        return 1
    plot_clusters(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
