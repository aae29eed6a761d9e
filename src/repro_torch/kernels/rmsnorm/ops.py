"""Wrapper of the fused RMSNorm kernel (flattens leading dims).

On a CPU tensor it computes the plain version (``ref.rmsnorm_ref``).  On
a CUDA tensor it launches ``csrc/rmsnorm.cu`` or raises; it never falls
back.  ``rmsnorm.launches`` counts kernel launches.

The decode step calls it dozens of times on a few rows, where the call
costs the host far more than the device, so the CUDA path does only what
the launch needs: no copy of a contiguous x or scale, no cast (the kernel
reads the scale in f32 or in x's dtype), one ``torch.empty_like`` and one
ctypes call; the kernel picks its 16-byte or narrow path from the
pointers and D.
"""
from __future__ import annotations

import torch

from .. import _build, refuse_grad
from .ref import rmsnorm_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_LAUNCH = _build.Entry("rmsnorm", "rmsnorm_launch", "pppiifiip")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) → x's shape and dtype:
    ``x * rsqrt(mean(x²) + eps) * scale`` in f32."""
    refuse_grad("rmsnorm", x, scale)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return rmsnorm_ref(x, scale, eps)
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"rmsnorm kernel takes bf16 or f32 x, got {x.dtype}")
    D = x.shape[-1]
    if scale.dtype is torch.float32:
        s_code = 1
    elif scale.dtype is x.dtype:
        s_code = code
    else:
        raise TypeError(f"rmsnorm kernel takes an f32 scale or one in x's "
                        f"dtype {x.dtype}, got {scale.dtype}")
    dev = x.get_device()
    if scale.shape != (D,) or scale.get_device() != dev:
        raise ValueError(f"rmsnorm: scale must be ({D},) on {x.device}, "
                         f"got {tuple(scale.shape)} on {scale.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    y = torch.empty_like(x)
    _LAUNCH(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
            x.numel() // D if D else 0, D, eps, code, s_code,
            _build.stream(dev))
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
