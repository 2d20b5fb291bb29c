"""Succinct integer codecs for the sparse-matrix artifacts.

The reference stores its pairwise matrix with the `bits` library's
compact_vector / rice_sequence / elias_fano (reference usage:
pairwise_comp_optimized.cpp:309-330,407-409,645-817 and
read_pc_mat_cmp.cpp:133-175,336-343,484-487,645-662). That submodule is not
pinned in the reference snapshot, so this framework defines its own
self-describing serialization (documented in FORMATS.md) with the same codec
semantics, implemented twice:

- :mod:`.pyref` — pure numpy, the executable spec and fallback.
- :mod:`.native` — C++ (native/codecs.cpp) via ctypes, the production path.

Both produce byte-identical output (tests/test_codecs.py enforces it).
The module-level functions dispatch to native when the shared library is
available, else to pyref.
"""

from __future__ import annotations

import numpy as np

from . import pyref

try:
    from . import native as _native
    _HAVE_NATIVE = _native.available()
except Exception:  # pragma: no cover - build environment without a compiler
    _native = None
    _HAVE_NATIVE = False


def have_native() -> bool:
    return _HAVE_NATIVE


_warned_fallback = False


def _impl():
    if not _HAVE_NATIVE:
        global _warned_fallback
        if not _warned_fallback:
            _warned_fallback = True
            import warnings
            warnings.warn(
                "native codec library unavailable (build failed or no "
                "compiler) — falling back to the numpy reference "
                "implementation; decodes will be slower", RuntimeWarning,
                stacklevel=3)
        return pyref
    return _native


def cv_encode(values) -> bytes:
    return _impl().cv_encode(np.asarray(values, dtype=np.uint64))


def cv_decode(buf, offset: int = 0):
    """-> (values ndarray uint64, bytes_consumed)"""
    return _impl().cv_decode(buf, offset)


def rice_encode(values) -> bytes:
    return _impl().rice_encode(np.asarray(values, dtype=np.uint64))


def rice_decode(buf, offset: int = 0):
    return _impl().rice_decode(buf, offset)


def ef_encode(values, universe: int) -> bytes:
    return _impl().ef_encode(np.asarray(values, dtype=np.uint64), universe)


def ef_decode(buf, offset: int = 0):
    return _impl().ef_decode(buf, offset)
