"""Device state of the port, from the JAX package's state.

Each function takes the JAX objects' arrays as numpy and returns the port's
tensors or objects, so the two packages can be fed identical state:

- :func:`from_reference_state`: the pairwise engine's (P, Npad, d) int8
  Karatsuba planes and (Npad,) float32 thresholds
  (``matrix/compute.py:307-388`` ``_stage_database``), d padded to
  ``d_pad`` with zero columns;
- :func:`int_index_from_reference`: an ``ann.int_index.IntExactIndex``'s
  (C, P, R, d) int8 plane stack, exact norms, L, chunk_rows and shape;
- :func:`flat_index_from_reference`: an ``ann.flat_index.FlatIPIndex``'s
  normalised float32 vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .ops.pairwise import pad_dim


def from_reference_state(planes: np.ndarray, thr: np.ndarray, device):
    """(P, Npad, d) int8 planes + (Npad,) float32 thresholds ->
    ((P, Npad, d_pad) int8, (Npad,) float32) tensors on ``device``."""
    dev = resolve_device(device)
    planes = np.asarray(planes)
    if planes.dtype != np.int8 or planes.ndim != 3:
        raise ValueError("planes must be a (P, Npad, d) int8 array")
    P, npad, d = planes.shape
    thr = np.asarray(thr, dtype=np.float32)
    if thr.shape != (npad,):
        raise ValueError(f"thr must have shape ({npad},)")
    out = torch.zeros((P, npad, pad_dim(d)), dtype=torch.int8, device=dev)
    out[:, :, :d] = torch.tensor(planes).to(dev)
    return out, torch.tensor(thr).to(dev)


def int_index_from_reference(stack: np.ndarray, ns: np.ndarray, L: int,
                             chunk_rows: int, shape, *, device,
                             max_abs: int | None = None, mode: str = "exact",
                             recall_target: float = 0.95):
    """A JAX IntExactIndex's state (``_stack`` (C, P, R, d) int8, ``ns``
    (n,) int64, ``L``, ``chunk_rows`` = R, ``(n, d)``) -> the port's
    IntExactIndex on ``device`` (R padded to pad_rows(R), d to d_pad)."""
    from .ann.int_index import IntExactIndex
    stack = np.asarray(stack)
    C, P, R, d = stack.shape
    if stack.dtype != np.int8 or R != chunk_rows or d != shape[1] \
            or C != (shape[0] + R - 1) // R:
        raise ValueError(f"stack {stack.shape} {stack.dtype} does not match "
                         f"chunk_rows={chunk_rows}, shape={shape}")
    self = IntExactIndex.__new__(IntExactIndex)
    self._setup(resolve_device(device), shape, R, max_abs, mode,
                recall_target, L=L)
    if self._stack.shape[1] != P:
        raise ValueError(f"{P} planes do not match L={L}")
    self._stack[:, :, :R, :d] = torch.tensor(stack).to(self.device)
    self.ns = np.asarray(ns, dtype=np.int64)
    self._finish_norms()
    return self


def flat_index_from_reference(vectors: np.ndarray, *, device,
                              chunk_rows: int = 65536,
                              precision: str = "f32"):
    """A JAX FlatIPIndex's normalised (n, d) float32 vectors -> the port's
    FlatIPIndex on ``device``."""
    from .ann.flat_index import FlatIPIndex
    return FlatIPIndex(vectors, chunk_rows=chunk_rows, precision=precision,
                       device=device)
