"""Explicit device resolution.

Every entry point of the port takes a device.  The default is ``cuda``; a
missing card is an error, never a silent switch to the CPU — the CPU runs
only when asked for by name (``--device cpu``), and then executes the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``cuda``); raises
    ``RuntimeError`` for a CUDA device when no card is available and
    ``ValueError`` for a device type the port does not run on."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (no CUDA card, or a CPU-only PyTorch build); pass "
                "device='cpu' / --device cpu to run the plain PyTorch path "
                "on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
