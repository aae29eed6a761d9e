"""Wrappers of the flash attention kernel.

``flash_attention`` takes the kernel layout of the reference kernel
(q ``(B·KVH, G, Sq, Dh)``, k/v ``(B·KVH, Skv, D)``); ``mha`` converts the
model layout ``(B, S, H, Dh)`` to it and back, as
``repro/kernels/flash_attention/ops.py`` does.

On CPU tensors the plain version (``ref.attention_ref``) runs.  On CUDA
tensors ``csrc/flash_attention.cu`` is launched or the call raises; it
never falls back.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: head dims the kernel is instantiated for (Dh == Dv)
HEAD_DIMS = (16, 32, 64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q (BH, G, Sq, Dh); k (BH, Skv, Dh); v (BH, Skv, Dv) →
    (BH, G, Sq, Dv) in q's dtype.  BH = batch × kv_heads, G = query
    group size."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    BH, G, Sq, Dh = q.shape
    Skv, Dv = k.shape[1], v.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes bf16 or f32 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if Dh != Dv or Dh not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention kernel is built for Dh == Dv in {HEAD_DIMS}, "
            f"got Dh={Dh}, Dv={Dv} (Dv != Dh is MLA: ROADMAP A9)")
    if k.shape != (BH, Skv, Dh) or v.shape[:2] != (BH, Skv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((BH, G, Sq, Dv), dtype=q.dtype, device=q.device)
    for t in (q, k, v, o):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs 16-byte aligned "
                             "tensors")
    err = _lib().flash_attention_launch(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
        BH, G, Sq, Skv, Dh, Dv, int(causal), int(window or 0),
        1.0 / math.sqrt(Dh), _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def to_kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B,Sq,H,Dh), (B,Skv,KVH,Dh) → (B·KVH,G,Sq,Dh), (B·KVH,Skv,Dh)."""
    B, Sq, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qk = q.reshape(B, Sq, KVH, G, Dh).permute(0, 2, 3, 1, 4) \
        .reshape(B * KVH, G, Sq, Dh)
    kk = k.permute(0, 2, 1, 3).reshape(B * KVH, -1, Dh)
    vk = v.permute(0, 2, 1, 3).reshape(B * KVH, -1, v.shape[-1])
    return qk, kk, vk


def from_kernel_layout(o: torch.Tensor, B: int) -> torch.Tensor:
    """(B·KVH, G, Sq, Dv) → (B, Sq, H, Dv)."""
    BH, G, Sq, Dv = o.shape
    KVH = BH // B
    return o.reshape(B, KVH, G, Sq, Dv).permute(0, 3, 1, 2, 4) \
        .reshape(B, Sq, KVH * G, Dv)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None) -> torch.Tensor:
    """q (B,Sq,H,Dh); k/v (B,Skv,KVH,Dh) with GQA → (B,Sq,H,Dv)."""
    qk, kk, vk = to_kernel_layout(q, k, v)
    o = flash_attention(qk, kk, vk, causal=causal, window=window)
    return from_kernel_layout(o, q.shape[0])
