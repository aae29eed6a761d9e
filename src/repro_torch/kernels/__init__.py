"""Hand-written Hopper kernels, one folder each: ``ops.py`` is the
wrapper the model calls, ``ref.py`` the plain PyTorch version of the same
function, and the CUDA source lives in ``repro_torch/csrc``."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` where autograd would need a gradient through
    kernel ``name``.  The kernels have no backward pass: their outputs
    carry no ``grad_fn``, so a gradient would stop there without a word.
    Training runs the plain paths, as the reference's does.  Each wrapper
    calls this on both devices (on the CPU its plain version stands in for
    the kernel); it reads host metadata only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written kernels carry no gradient; training "
            "runs the plain paths (use_kernels=False), as the reference's "
            "train step does")
