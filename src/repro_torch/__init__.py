"""PyTorch port of the ``repro`` package, for one NVIDIA H100.

``repro`` (JAX) is the reference and stays as it is; this package keeps
its module names and layout so every function has an obvious
counterpart.  It imports ``torch`` and never JAX or anything of
``repro``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card it raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card
    raises: a run that asked for the GPU never lands on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


__all__ = ["resolve_device"]
