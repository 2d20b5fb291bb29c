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
