"""Device selection: explicit, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch

# the device the command-line tools run on unless --device says otherwise
CLI_DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """torch.device for a caller's explicit choice; raises when CUDA is
    asked for and is not available (the CPU is used only when the caller
    passes it)."""
    if device is None:
        raise ValueError("an explicit device is required ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu (or device='cpu') to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


# the one card a multi-process run bound this process to
# (parallel.multihost.initialize); None: every visible card is this
# process's
_BOUND_CARD: torch.device | None = None


def bind_card(index: int) -> torch.device:
    """Make cuda:index this process's only card, and PyTorch's current
    device (one process per card on a node whose processes all see every
    card)."""
    global _BOUND_CARD
    torch.cuda.set_device(index)
    _BOUND_CARD = torch.device("cuda", index)
    return _BOUND_CARD


def local_cards() -> list:
    """This process's cards: the one it was bound to (:func:`bind_card`),
    else every visible card."""
    if _BOUND_CARD is not None:
        return [_BOUND_CARD]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_device_count(dev: torch.device) -> int:
    """Devices of dev's type this process has: its cards
    (:func:`local_cards`) for CUDA, one for the CPU."""
    return len(local_cards()) if dev.type == "cuda" else 1


def serving_devices(mesh_devices: int, dev: torch.device) -> int:
    """The devices a --mesh_devices value asks for on dev's type (the JAX
    package's parallel/mesh.py::serving_mesh convention): 1 is one device,
    0 every local device (:func:`local_device_count`), n > 1 the first n.
    Raises ValueError for n < 0 and for n above the local count."""
    if mesh_devices < 0:
        raise ValueError(f"--mesh_devices must be >= 0, got {mesh_devices}")
    if mesh_devices == 1:
        return 1
    have = local_device_count(dev)
    n = mesh_devices or have
    if n > have:
        raise ValueError(f"--mesh_devices {mesh_devices}: need {n} local "
                         f"devices, have {have}")
    return n
