"""Wrapper of the mLSTM chunkwise kernel, in the model layout.

``mlstm_chunk`` takes q, k, v ``(B, S, H, Dh)`` and the gate
pre-activations ``(B, S, H)`` and returns ``(B, S, H·Dh)`` f32, as
``repro/kernels/mlstm_chunk/ops.py`` does.  On CPU tensors it computes the
plain version (``ref.mlstm_chunk_ref`` over the kernel layout
``(B·H, S, Dh)``).  On CUDA tensors it launches ``csrc/mlstm_chunk.cu``
(a scores kernel, then the recurrence), which reads the model layout
through strides and writes the output layout directly, or raises; it
never falls back.
``mlstm_chunk.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import mlstm_chunk_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: time steps per chunk inside the CUDA kernel (the output does not
#: depend on the chunking beyond rounding)
KERNEL_CHUNK = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_chunk")
    fn = lib.mlstm_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def to_kernel_layout(q, k, v, i_pre, f_pre):
    """(B,S,H,Dh) / (B,S,H) → (B·H,S,Dh) / (B·H,S), as the reference's
    ``ops.py`` reshapes them."""
    B, S, H, Dh = q.shape

    def tok(x):
        return x.transpose(1, 2).reshape(B * H, S, Dh)

    def gate(x):
        return x.transpose(1, 2).reshape(B * H, S)
    return tok(q), tok(k), tok(v), gate(i_pre), gate(f_pre)


def mlstm_chunk_plain(q, k, v, i_pre, f_pre, *, chunk: int = 128
                      ) -> torch.Tensor:
    """The plain version in the model layout: (B,S,H,Dh) → (B,S,H·Dh)."""
    B, S, H, Dh = q.shape
    y = mlstm_chunk_ref(*to_kernel_layout(q, k, v, i_pre, f_pre),
                        chunk=chunk)
    return y.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                chunk: int = 128) -> torch.Tensor:
    """q,k,v (B,S,H,Dh); i_pre,f_pre (B,S,H) → (B,S,H·Dh) f32.

    Raises where the reference asserts: ``S`` must be a multiple of
    ``min(chunk, S)``."""
    B, S, H, Dh = q.shape
    if S % min(chunk, S):
        raise ValueError(f"mlstm_chunk: S={S} is not a multiple of the "
                         f"chunk {min(chunk, S)}")
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, i_pre, f_pre, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk: unsupported device {q.device}")
    ts = (q, k, v, i_pre, f_pre)
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise TypeError("mlstm_chunk kernel takes bf16 or f32 inputs of "
                        f"one dtype, got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("mlstm_chunk: inputs on different devices")
    if k.shape != q.shape or v.shape != q.shape or \
            i_pre.shape != (B, S, H) or f_pre.shape != (B, S, H):
        raise ValueError(f"mlstm_chunk: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, i "
                         f"{tuple(i_pre.shape)}, f {tuple(f_pre.shape)}")
    # q, k and v share one (B, S, H) stride triple with unit stride on Dh
    # (views of one qkv projection do); anything else is copied.
    if q.stride(3) != 1 or k.stride() != q.stride() or \
            v.stride() != q.stride():
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if f_pre.stride() != i_pre.stride():
        i_pre, f_pre = i_pre.contiguous(), f_pre.contiguous()
    if B * H > 65535:
        raise ValueError(f"mlstm_chunk kernel: B*H={B * H} exceeds the "
                         "grid's 65535 rows")
    y = torch.empty((B, S, H, Dh), dtype=torch.float32, device=q.device)
    # raw q kᵀ of every chunk, written by the first kernel and read by
    # the second; freeing it on return is safe, as the caching allocator
    # hands its memory only to work queued later on this stream
    n_chunks = -(-S // KERNEL_CHUNK)
    scores = torch.empty((B * H, n_chunks * KERNEL_CHUNK, KERNEL_CHUNK),
                         dtype=torch.float32, device=q.device)
    err = _lib().mlstm_chunk_launch(
        *(ctypes.c_void_p(t.data_ptr())
          for t in (q, k, v, i_pre, f_pre, scores, y)),
        B, S, H, Dh, *q.stride()[:3], *i_pre.stride(),
        _DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check(err, "mlstm_chunk")
    mlstm_chunk.launches += 1
    return y.reshape(B, S, H * Dh)


mlstm_chunk.launches = 0
