"""Wrapper of the selective-scan kernel.

``ssd_scan`` takes x, dt ``(B, S, Din)``, A ``(Din, N)`` and B, C
``(B, S, N)`` and returns y ``(B, S, Din)`` f32, as
``repro/kernels/ssd_scan/ops.py`` does.  On CPU tensors it computes the
plain version (``ref.ssd_scan_ref``, the sequential recurrence).  On CUDA
tensors it launches ``csrc/ssd_scan.cu`` or raises; it never falls back.
``ssd_scan.launches`` counts kernel launches.

The kernel reads x and dt (bf16 or f32 each) through their batch and
sequence strides, 16 bytes at a time: with unit stride along Din, both
strides multiples of 8 and 16-byte aligned data, views of a projection
need no copy; anything else is copied.  A, B and C are handed to it as
contiguous f32 (B and C are ``(B, S, N)``: a few hundred KiB).  The
kernel takes N in {4, 8, 16} and Din a multiple of 8.
"""
from __future__ import annotations

import torch

from .. import _build, refuse_grad
from .ref import ssd_scan_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
KERNEL_N = (4, 8, 16)


_LAUNCH = _build.Entry("ssd_scan", "ssd_scan_launch", "ppppppiiiiqqqqiip")


def _streamable(t: torch.Tensor) -> bool:
    """Rows the kernel can copy 16 bytes at a time."""
    return (t.stride(2) == 1 and t.stride(1) % 8 == 0
            and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             d_block: int = 128) -> torch.Tensor:
    """x, dt (B,S,Din); A (Din,N); Bm, Cm (B,S,N) → y (B,S,Din) f32.

    Raises where the reference asserts: ``S`` must be a multiple of
    ``min(chunk, S)`` and ``Din`` of ``min(d_block, Din)``.  The output
    depends on neither beyond that check."""
    B, S, Din = x.shape
    N = A.shape[-1]
    if S % min(chunk, S) or Din % min(d_block, Din):
        raise ValueError(f"ssd_scan: S={S} must be a multiple of the chunk "
                         f"{min(chunk, S)} and Din={Din} of the d_block "
                         f"{min(d_block, Din)}")
    refuse_grad("ssd_scan", x, dt, A, Bm, Cm)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    ts = (x, dt, A, Bm, Cm)
    if any(t.device != x.device for t in ts):
        raise ValueError("ssd_scan: inputs on different devices")
    if any(t.dtype not in _DTYPE_CODE for t in ts):
        raise TypeError("ssd_scan kernel takes bf16 or f32 inputs, got "
                        f"{[t.dtype for t in ts]}")
    if dt.shape != x.shape or A.shape != (Din, N) or \
            Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if N not in KERNEL_N or Din % 8:
        raise NotImplementedError(f"ssd_scan kernel takes N in {KERNEL_N} "
                                  f"and Din % 8 == 0, got N={N}, Din={Din}")
    if B > 65535:
        raise ValueError(f"ssd_scan kernel: B={B} exceeds the grid's 65535")
    x, dt = (t if _streamable(t) else t.contiguous() for t in (x, dt))
    # f32, contiguous and 16-byte aligned (the kernel reads float4s); the
    # copies may be freed on return, as the caching allocator hands their
    # memory only to work queued later on this stream
    A, Bm, Cm = (t.to(torch.float32).contiguous() for t in (A, Bm, Cm))
    A, Bm, Cm = (t.clone() if t.data_ptr() % 16 else t for t in (A, Bm, Cm))
    y = torch.empty((B, S, Din), dtype=torch.float32, device=x.device)
    _LAUNCH(*(t.data_ptr() for t in (x, dt, A, Bm, Cm, y)),
            B, S, Din, N, x.stride(0), x.stride(1), dt.stride(0),
            dt.stride(1), _DTYPE_CODE[x.dtype], _DTYPE_CODE[dt.dtype],
            _build.stream(x.get_device()))
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
