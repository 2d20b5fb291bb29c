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


def serving_devices(mesh_devices: int, dev: torch.device) -> int:
    """The devices a --mesh_devices value asks for on dev's type (the JAX
    package's parallel/mesh.py::serving_mesh convention): 1 is one device,
    0 every local device (1 on the CPU, torch.cuda.device_count() on CUDA),
    n > 1 the first n."""
    if mesh_devices < 0:
        raise ValueError(f"--mesh_devices must be >= 0, got {mesh_devices}")
    if mesh_devices:
        return mesh_devices
    return torch.cuda.device_count() if dev.type == "cuda" else 1
