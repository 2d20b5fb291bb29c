"""The port's numpy-only pairwise math equals its JAX-package twin
(metagenome_vector_sketches_tpu_torch/ops/pairwise_math.py vs
metagenome_vector_sketches_tpu/ops/pairwise.py), exactly, on random inputs
for L = 1..5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.ops import pairwise as ref  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ops import pairwise_math as pm  # noqa: E402

LIMBS = [1, 2, 3, 4, 5]
# the largest |component| each limb count covers
MAX_FOR_L = {1: 127, 2: 8127, 3: 1040319, 4: 133160895}


@pytest.mark.parametrize("L", LIMBS)
def test_plane_bookkeeping(L):
    P = pm.num_planes(L)
    assert P == ref.num_planes(L)
    assert pm.limbs_from_planes(P) == ref.limbs_from_planes(P) == L
    np.testing.assert_array_equal(pm.plane_weights(L), ref.plane_weights(L))
    assert pm.plane_weights(L).dtype == np.float32
    np.testing.assert_array_equal(pm.plane_weights_int(L),
                                  ref.plane_weights_int(L))


@pytest.mark.parametrize("L", LIMBS)
def test_limb_choice_and_bounds(L):
    rng = np.random.default_rng(L)
    lo = MAX_FOR_L.get(L - 1, 0)
    hi = MAX_FOR_L.get(L, 2**31 - 1)
    for m in [lo + 1, hi, *rng.integers(lo + 1, hi + 1, size=20).tolist()]:
        m = int(m)
        assert pm.pick_limbs(m) == ref.pick_limbs(m) == L, m
        assert pm._balanced_top(m, L) == ref._balanced_top(m, L)
        assert pm._balanced_top(-m, L) == ref._balanced_top(-m, L)
        assert pm.plane_value_bounds(L, m) == ref.plane_value_bounds(L, m)
        for d in (64, 200, 2048):
            assert pm.required_slack_abs(L, m, d) == \
                ref.required_slack_abs(L, m, d)
            assert pm.threshold_adjust(L, m, d) == \
                ref.threshold_adjust(L, m, d)


def test_check_exact_dot_range_matches():
    for d, m in [(2048, 2**20), (2048, 2**26), (2**20, 2**21), (64, 1)]:
        outcome = []
        for fn in (pm.check_exact_dot_range, ref.check_exact_dot_range):
            try:
                fn(d, m)
                outcome.append(True)
            except ValueError:
                outcome.append(False)
        assert outcome[0] == outcome[1], (d, m)
    with pytest.raises(ValueError):
        pm.check_exact_dot_range(2048, 2**31)


@pytest.mark.parametrize("L", LIMBS)
def test_decompose_limbs_host(L):
    rng = np.random.default_rng(10 + L)
    m = min(MAX_FOR_L.get(L, 2**31 - 1), 2**31 - 1 - 64)
    v = rng.integers(-m, m + 1, size=(17, 33)).astype(np.int32)
    v[0, :2] = [m, -m]
    got = pm.decompose_limbs_host(v, L)
    np.testing.assert_array_equal(got, ref.decompose_limbs_host(v, L))
    w = (1 << (7 * np.arange(L, dtype=np.int64)))
    np.testing.assert_array_equal(
        np.tensordot(w, got.astype(np.int64), axes=1), v)


def test_slack_constants():
    assert pm.SLACK_REL == ref.SLACK_REL and pm.SLACK_REL.dtype == np.float32
    assert pm.SLACK_ABS == ref.SLACK_ABS and pm.SLACK_ABS.dtype == np.float32


@pytest.mark.parametrize("L", LIMBS)
def test_combine_plane_partials_and_exact_filters(L):
    rng = np.random.default_rng(20 + L)
    P = pm.num_planes(L)
    parts = rng.integers(-2**24, 2**24, size=(P, 300)).astype(np.int32)
    np.testing.assert_array_equal(pm.combine_plane_partials(parts, L),
                                  ref.combine_plane_partials(parts, L))
    d = 2048
    dots = rng.integers(-2**40, 2**40, size=500)
    dots[:3] = [-d - 1, d * 7, 0]           # truncation edges
    thr = rng.uniform(-10, 2**40 / d, size=500)
    np.testing.assert_array_equal(pm.exact_filter_int32(dots, thr, d),
                                  ref.exact_filter_int32(dots, thr, d))
    np.testing.assert_array_equal(pm.exact_filter_int16(dots, thr, d),
                                  ref.exact_filter_int16(dots, thr, d))


@pytest.mark.parametrize("max_abs,d", [(3000, 100), (1 << 23, 256)])
def test_exact_dots_host(max_abs, d):
    """The float64 branch and, at d * max_abs^2 >= 2^53, the int64 one; a
    chunk smaller than the pairs."""
    rng = np.random.default_rng(max_abs)
    V = rng.integers(-max_abs, max_abs + 1, size=(40, d)).astype(np.int32)
    V[0, :2] = [max_abs, -max_abs]
    rows = rng.integers(0, 40, size=3000)
    cols = rng.integers(0, 40, size=3000)
    rows[:2], cols[:2] = 0, 0
    want = ref.exact_dots_host(V, rows, cols, max_abs)
    np.testing.assert_array_equal(pm.exact_dots_host(V, rows, cols, max_abs),
                                  want)
    np.testing.assert_array_equal(
        pm.exact_dots_host(V, rows, cols, max_abs, chunk=1024), want)
    np.testing.assert_array_equal(
        want, np.einsum("kd,kd->k", V[rows].astype(object),
                        V[cols].astype(object)).astype(np.int64))
    with pytest.raises(ValueError, match="overflow"):
        pm.exact_dots_host(V, rows, cols, 1 << 31)
