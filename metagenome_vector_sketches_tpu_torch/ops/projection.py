"""Seeded +-1 random projection of hash sets into Z^d (the sketch step).

For each hash h of a set and each 64-lane block b, x = splitmix64(h + 64 b);
lane n of block b receives 1 - 2*bit_n(x), so the sketch is
``count - 2 * bitsum`` (reference src/random_projection.cpp:9-26). The sum
is order-independent, so any batching of the sets is exact.

Ragged sets travel as CSR: a flat int64 tensor of hash bit patterns and
int64 offsets (``offsets[i]:offsets[i+1]`` is set i). A CUDA tensor goes
through kernel P (``csrc/projection.cu``); a CPU tensor through the plain
PyTorch version :func:`project_batch_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from .splitmix import splitmix64


def _byte_bits(device) -> torch.Tensor:
    """(256, 8) uint8: bit n of byte value v (little bit order)."""
    v = torch.arange(256, device=device, dtype=torch.int32)
    return ((v[:, None] >> torch.arange(8, device=device,
                                        dtype=torch.int32)) & 1).to(torch.uint8)


def project_batch_plain(hashes: torch.Tensor, offsets: torch.Tensor,
                        d: int) -> torch.Tensor:
    """Plain PyTorch projection of CSR hash sets -> (B, d) int32, on the
    tensors' device."""
    dev = hashes.device
    B = offsets.numel() - 1
    nb = (d + 63) // 64
    counts = offsets[1:] - offsets[:-1]
    set_id = torch.repeat_interleave(
        torch.arange(B, device=dev, dtype=torch.int64), counts)
    bitsum = torch.zeros(B, nb * 64, dtype=torch.int32, device=dev)
    blocks = torch.arange(nb, device=dev, dtype=torch.int64) * 64
    lut = _byte_bits(dev)
    chunk = max(1, (32 << 20) // (nb * 64 * 4))
    H = hashes.numel()
    for s in range(0, H, chunk):
        e = min(s + chunk, H)
        x = splitmix64(hashes[s:e, None] + blocks[None, :])     # (h, nb)
        bytes_ = x.contiguous().view(torch.uint8).to(torch.int32)
        bits = lut[bytes_].reshape(e - s, nb * 64)             # lane order
        bitsum.index_add_(0, set_id[s:e], bits.to(torch.int32))
    out = counts.to(torch.int32)[:, None] - 2 * bitsum
    return out[:, :d].contiguous()


# kernel P's work item: at most CHUNK hashes of one set (chosen on an H100:
# PERF.md). MAX_CHUNK is the kernel's limit (csrc/projection.cu
# counts up to 4,095 words per lane without a flush)
MAX_CHUNK = 4095
CHUNK = 1024


def chunk_items(offsets: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Kernel P's work items: each set of the CSR ``offsets`` is cut into
    items of at most ``chunk`` hashes, an empty set into one empty item.
    -> (B + 1,) int64 item offsets: set s owns items item_off[s] ..
    item_off[s + 1] - 1. Computed on the offsets' device, without
    synchronising."""
    counts = offsets[1:] - offsets[:-1]
    per_set = torch.clamp((counts + chunk - 1) // chunk, min=1)
    item_off = torch.zeros(offsets.numel(), dtype=torch.int64,
                           device=offsets.device)
    torch.cumsum(per_set, 0, out=item_off[1:])
    return item_off


def item_bounds(offsets: torch.Tensor, item_off: torch.Tensor,
                chunk: int = CHUNK):
    """Plain version of the kernel's item lookup: -> (set, start, end) int64
    tensors of every item (hashes[start:end] of set ``set``)."""
    items = torch.arange(int(item_off[-1]), device=offsets.device)
    set_ = torch.searchsorted(item_off, items, right=True) - 1
    start = offsets[set_] + (items - item_off[set_]) * chunk
    return set_, start, torch.minimum(start + chunk, offsets[set_ + 1])


def _project_cuda(hashes: torch.Tensor, offsets: torch.Tensor,
                  item_off: torch.Tensor, d: int,
                  chunk: int) -> torch.Tensor:
    """Kernel P on the work items ``item_off`` (:func:`chunk_items` of
    ``offsets`` at ``chunk``)."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}]")
    for name, t in (("hashes", hashes), ("offsets", offsets),
                    ("item_off", item_off)):
        if t.dtype != torch.int64 or not t.is_contiguous() or t.ndim != 1 \
                or t.device != hashes.device:
            raise ValueError(f"{name} must be a contiguous 1-D int64 tensor "
                             "on the hashes' device")
    B = offsets.numel() - 1
    if B >= 2**31 or (B + 1) * d >= 2**62 or item_off.numel() != B + 1:
        raise ValueError(f"batch of {B} sets at d={d} is too large or its "
                         "items do not match")
    out = torch.empty(B, d, dtype=torch.int32, device=hashes.device)
    if B == 0 or d == 0:
        return out
    lib = _build.library()
    with _build.launch_stream(hashes.device) as stream:
        rc = lib.mvs_project(hashes.data_ptr(), offsets.data_ptr(),
                             item_off.data_ptr(), B,
                             B + hashes.numel() // chunk, chunk, d,
                             out.data_ptr(), stream)
    _build.check(rc, "projection kernel")
    _build.count_launch("projection")
    return out


def project_batch(hashes_flat, offsets, d: int, device) -> torch.Tensor:
    """Project CSR hash sets (int64 bit patterns + int64 offsets, numpy or
    torch) on ``device`` -> (B, d) int32 tensor on that device."""
    dev = resolve_device(device)
    h = torch.as_tensor(hashes_flat, dtype=torch.int64).to(dev).contiguous()
    o = torch.as_tensor(offsets, dtype=torch.int64).to(dev).contiguous()
    if dev.type == "cpu":
        return project_batch_plain(h, o, d)
    return _project_cuda(h, o, chunk_items(o, CHUNK), d, CHUNK)


# project_many's batch bounds (the device holds a batch's hashes and its
# (sets, d) int32 output at once)
BATCH_HASHES = 1 << 26
BATCH_SETS = 1 << 15


def _as_u64_array(hs) -> np.ndarray:
    if isinstance(hs, np.ndarray):
        return np.ascontiguousarray(hs, dtype=np.uint64)
    return np.fromiter((int(h) for h in hs), dtype=np.uint64)


def project_many(hash_sets, d: int, device) -> np.ndarray:
    """Project a list of hash sets -> (N, d) int32 numpy matrix, in batches
    of at most BATCH_SETS sets and BATCH_HASHES hashes (or one set)."""
    dev = resolve_device(device)
    arrays = [_as_u64_array(h) for h in hash_sets]
    N = len(arrays)
    sizes = np.fromiter((len(a) for a in arrays), dtype=np.int64, count=N)
    out = np.empty((N, d), dtype=np.int32)
    s = 0
    while s < N:
        e, tot = s + 1, int(sizes[s])
        while e < N and e - s < BATCH_SETS and tot + sizes[e] <= BATCH_HASHES:
            tot += int(sizes[e])
            e += 1
        flat = np.concatenate(arrays[s:e]) if tot else \
            np.empty(0, dtype=np.uint64)
        offsets = np.zeros(e - s + 1, dtype=np.int64)
        np.cumsum(sizes[s:e], out=offsets[1:])
        out[s:e] = project_batch(flat.view(np.int64), offsets, d,
                                 dev).cpu().numpy()
        s = e
    return out
