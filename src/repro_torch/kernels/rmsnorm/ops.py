"""Wrapper of the fused RMSNorm kernel (flattens leading dims).

On a CPU tensor it computes the plain version (``ref.rmsnorm_ref``).  On
a CUDA tensor it launches ``csrc/rmsnorm.cu`` or raises; it never falls
back.  ``rmsnorm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rmsnorm_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) → x's shape and dtype:
    ``x * rsqrt(mean(x²) + eps) * scale`` in f32."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rmsnorm kernel takes bf16 or f32 x, got {x.dtype}")
    if D % 8:
        raise ValueError(f"rmsnorm kernel needs D % 8 == 0, got D={D}")
    if scale.shape != (D,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale must be ({D},) on {x.device}, "
                         f"got {tuple(scale.shape)} on {scale.device}")
    x2 = x.reshape(-1, D).contiguous()
    s = scale.to(torch.float32).contiguous()
    y = torch.empty_like(x2)
    for t in (x2, s, y):
        if t.data_ptr() % 16:
            raise ValueError("rmsnorm kernel needs 16-byte aligned tensors")
    err = _lib().rmsnorm_launch(
        ctypes.c_void_p(x2.data_ptr()), ctypes.c_void_p(s.data_ptr()),
        ctypes.c_void_p(y.data_ptr()), x2.shape[0], D, eps,
        _DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return y.reshape(x.shape)


rmsnorm.launches = 0
