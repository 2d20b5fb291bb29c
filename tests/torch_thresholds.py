"""The port's per-row sweep thresholds, computed for the port's tests: the
plane energies of int rows in numpy, every row's float32 threshold of a db
folder, the JAX engines run under those thresholds, and the port's shard
counters held against the JAX engine's. The JAX package is imported only
by :func:`jax_under_port_thresholds`."""

import contextlib

import numpy as np
import pytest

from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm


def plane_energies(V, L):
    """(P, n) int64 energies E_p(i) = sum_k plane_p(i, k)^2 of the int rows
    V: numpy's sums of the squares of their L limbs and Karatsuba planes."""
    limbs = pm.decompose_limbs_host(V, L).astype(np.int64)
    planes = [limbs[k] for k in range(L)] + [
        limbs[a] + limbs[b] for a in range(L) for b in range(a + 1, L)]
    return np.stack([np.einsum("nd,nd->n", p, p) for p in planes])


def port_thresholds(db_folder):
    """The port's float32 sweep thresholds of every row of a db folder
    (matrix.compute._thresholds), from the db's squared norms and the
    :func:`plane_energies` of its rows."""
    db = DbFolder(db_folder)
    _, norms = db.names_and_norms()
    V = db.load_vectors().astype(np.int32)
    L = pm.pick_limbs(max(1, int(np.abs(V).max(initial=0))))
    return tmc._thresholds(norms * norms, plane_energies(V, L), L,
                           db.dimension)[0]


@contextlib.contextmanager
def jax_under_port_thresholds(db_folder):
    """Inside the block the JAX package's engines sweep db_folder under the
    port's per-row thresholds (:func:`port_thresholds`) in place of their
    db-wide ``threshold_adjust``: their candidates and emitted counts are
    then those of the JAX float32 mask (its approx_dot_f32 and threshold
    expression) under the port's thresholds, in the JAX engine's own tile
    grid. The JAX residency slot is emptied on entry and on exit."""
    from metagenome_vector_sketches_tpu.matrix import compute as jmc
    from metagenome_vector_sketches_tpu.ops import pairwise as jpw
    thr = port_thresholds(db_folder)
    _, norms = DbFolder(db_folder).names_and_norms()
    # norms_sq + adj rounds back to thr exactly: adj is within a float64
    # rounding of thr - norms_sq
    adj = thr.astype(np.float64) - norms * norms
    jmc.clear_device_cache()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpw, "threshold_adjust", lambda L, max_abs, d: adj)
        try:
            yield thr
        finally:
            jmc.clear_device_cache()


def assert_port_counts(port, jax, jax_port_thr,
                       keys=("candidates", "emitted")):
    """The port engine's shard counters against the JAX engine's on the
    same shard: pairs_written equal to the JAX engine's; each of ``keys``
    equal to the JAX engine's under the port's thresholds
    (:func:`jax_under_port_thresholds`), and no more than its own (the
    port's thresholds are never below the JAX engine's)."""
    assert port["pairs_written"] == jax["pairs_written"] \
        == jax_port_thr["pairs_written"]
    for k in keys:
        assert port[k] == jax_port_thr[k] <= jax[k], k
