"""Wrappers of the flash attention kernel.

``flash_attention`` takes the kernel layout of the reference kernel
(q ``(B·KVH, G, Sq, Dh)``, k/v ``(B·KVH, Skv, D)``); ``mha`` converts the
model layout ``(B, S, H, Dh)`` to it and back, as
``repro/kernels/flash_attention/ops.py`` does.

On CPU tensors the plain version (``ref.attention_ref``) runs.  On CUDA
tensors ``csrc/flash_attention.cu`` is launched or the call raises; it
never falls back.  ``flash_attention.launches`` counts kernel launches.

The kernel takes any head dim up to 128 with Dv == Dh (``kernel_dims``):
it is built for the widths ``WIDTHS`` and zero-fills the columns between
a row's head dim and its width in shared memory.  Rows must be whole
16-byte chunks; a head dim whose rows are not (bf16 Dh 12: 24 bytes) is
zero-padded here, in a copy of q, k and v, to the next such width, and
the output is cut back.  The kernel still runs; the copy is the
wrapper's only extra work, on the small models that have such heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _build, refuse_grad
from .ref import attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: the widths the kernel is built for; a head dim runs at the next one
WIDTHS = (16, 32, 64, 80, 128)
_LAUNCH = _build.Entry("flash_attention", "flash_attention_launch",
                       "ppppiiiiiiiifip")


def kernel_dims(dh: int, dv: int, elt: int) -> tuple[int, int]:
    """(row, width) for head dim ``dh`` at ``elt`` bytes per element.

    ``row`` is dh rounded up to whole 16-byte chunks (the wrapper pads q,
    k and v to it where it differs); ``width`` is the smallest built width
    that holds ``row`` (the kernel zero-fills the columns between them).
    Dh > 128 and Dv != Dh raise ``NotImplementedError``."""
    if dv != dh or not 0 < dh <= WIDTHS[-1]:
        raise NotImplementedError(
            f"flash_attention kernel takes Dh == Dv <= {WIDTHS[-1]}, got "
            f"Dh={dh}, Dv={dv} (Dv != Dh, as MLA's Dh 192 and Dv 128, is "
            "ROADMAP B6.1(c); the reference's MLA calls no kernel)")
    step = 16 // elt
    row = -(-dh // step) * step
    return row, next(w for w in WIDTHS if w >= row)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q (BH, G, Sq, Dh); k (BH, Skv, Dh); v (BH, Skv, Dv) →
    (BH, G, Sq, Dv) in q's dtype.  BH = batch × kv_heads, G = query
    group size."""
    refuse_grad("flash_attention", q, k, v)
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
    row, width = kernel_dims(Dh, Dv, q.element_size())
    if k.shape != (BH, Skv, Dh) or v.shape[:2] != (BH, Skv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be > 0, got {window}")
    if row != Dh:
        q, k, v = (F.pad(t, (0, row - Dh)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty((BH, G, Sq, row), dtype=q.dtype, device=q.device)
    for t in (q, k, v, o):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention kernel needs 16-byte aligned "
                             "tensors")
    dev = q.get_device()
    _LAUNCH(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            BH, G, Sq, Skv, row, width, int(causal), int(window or 0),
            1.0 / math.sqrt(Dh), _DTYPE_CODE[q.dtype], _build.stream(dev))
    flash_attention.launches += 1
    return o if row == Dh else o[..., :Dh]


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
    refuse_grad("mha", q, k, v)
    qk, kk, vk = to_kernel_layout(q, k, v)
    o = flash_attention(qk, kk, vk, causal=causal, window=window)
    return from_kernel_layout(o, q.shape[0])
