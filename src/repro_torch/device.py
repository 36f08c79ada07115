"""Device pick for the port: the CUDA card unless the caller asks for the CPU.

There is no silent CPU route: asking for ``cuda`` on a host without a card
raises, and the CPU runs only when a caller names it (the tests do, through
``core.distance.set_default_device("cpu")`` or a ``device=`` argument).
"""

from __future__ import annotations

import torch

_DEFAULT_DEVICE = "cuda"


def default_device() -> str:
    """The process-wide device an entry point uses when none is given."""
    return _DEFAULT_DEVICE


def set_default_device(device: str) -> None:
    """Set the process-wide default device ("cuda", "cuda:N" or "cpu")."""
    global _DEFAULT_DEVICE
    torch.device(device)  # raises on a malformed name
    _DEFAULT_DEVICE = str(device)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` or the process default.
    Raises ``RuntimeError`` for a CUDA device when CUDA is not available."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def kernels_built() -> bool:
    """Whether this process has built and loaded the CUDA kernel library.
    For reporting only: no code path chooses a route by it."""
    from repro_torch.kernels import _build

    return _build.loaded()
