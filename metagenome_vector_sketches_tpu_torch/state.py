"""Device state of the pairwise engine, from the JAX package's staged state.

The JAX engine stages a database as (P, Npad, d) int8 Karatsuba planes and
(Npad,) float32 thresholds (``matrix/compute.py:307-388``
``_stage_database``). :func:`from_reference_state` turns those arrays
(as numpy) into the port's tensors, padding d to ``d_pad`` with zero
columns, so the two sweeps can be fed identical state.
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
