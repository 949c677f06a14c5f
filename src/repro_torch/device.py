"""Device resolution shared by every entry point.

The port runs on ``cuda`` unless the caller asks for the CPU. With no
CUDA device present and no explicit ``device="cpu"``, entry points raise
:class:`CudaUnavailableError` instead of carrying on silently on the
CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


class CudaUnavailableError(RuntimeError):
    """A CUDA device was wanted (the default) but none is available."""


def resolve_device(device: str | torch.device | None = None, *,
                   meta: bool = False) -> torch.device:
    """``None`` means ``cuda``; a CUDA device must exist, else
    :class:`CudaUnavailableError`. ``"cpu"`` is honoured as asked, and
    ``"meta"`` (shapes and dtypes, no storage) where the caller allows it
    (``meta=True``: the initializers, for the dry-run)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if meta and dev.type == "meta":
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            f"device {str(dev)!r} requested (the default) but torch.cuda."
            "is_available() is False; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
