"""Wrapper of the mLSTM chunkwise kernel, in the model layout.

``mlstm_chunk`` takes q, k, v ``(B, S, H, Dh)`` and the gate
pre-activations ``(B, S, H)`` and returns ``(B, S, H·Dh)`` f32, as
``repro/kernels/mlstm_chunk/ops.py`` does.  On CPU tensors it computes the
plain version (``ref.mlstm_chunk_ref`` over the kernel layout
``(B·H, S, Dh)``).  On CUDA tensors it launches ``csrc/mlstm_chunk.cu``
or raises; it never falls back.  One call launches two kernels, a state
pass and an output pass (``ref.mlstm_chunk_two_pass`` is their blocking
in plain PyTorch); ``mlstm_chunk.launches`` counts calls that launch
them.  The kernels read the model layout through strides and write the
output layout directly; q, k and v are copied only where their rows are
not whole 16-byte chunks (they are then zero-padded to the next).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build, refuse_grad
from .ref import mlstm_chunk_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
#: time steps per chunk inside the CUDA kernel (the output does not
#: depend on the chunking beyond rounding)
KERNEL_CHUNK = 64
#: the kernel's tile of the matrix memory C: the states are padded to it
KERNEL_TILE = 64
_LAUNCH = _build.Entry("mlstm_chunk", "mlstm_chunk_launch",
                       "pppppppiiiiiqqqqqqip")


def scratch_floats(B: int, S: int, H: int, dp: int) -> int:
    """f32 scratch of one launch: C, n and m entering every chunk."""
    dpad = -(-dp // KERNEL_TILE) * KERNEL_TILE
    return B * H * -(-S // KERNEL_CHUNK) * (dpad * dpad + dpad + 1)


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
    refuse_grad("mlstm_chunk", q, k, v, i_pre, f_pre)
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
    # (views of one qkv projection do), rows of whole 16-byte chunks at
    # 16-byte aligned addresses; anything else is copied, zero-padded to
    # rows of dp elements
    vec = 16 // q.element_size()
    dp = -(-Dh // vec) * vec
    if q.stride(3) != 1 or k.stride() != q.stride() or \
            v.stride() != q.stride() or dp != Dh or \
            any(st % vec for st in q.stride()[:3]) or \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        q, k, v = (F.pad(t, (0, dp - Dh)).contiguous() for t in (q, k, v))
    if f_pre.stride() != i_pre.stride():
        i_pre, f_pre = i_pre.contiguous(), f_pre.contiguous()
    if B * H > 65535 or -(-S // KERNEL_CHUNK) > 65535:
        raise ValueError(f"mlstm_chunk kernel: B*H={B * H} and the "
                         f"{-(-S // KERNEL_CHUNK)} chunks must not exceed "
                         "the grid's 65535")
    y = torch.empty((B, S, H, Dh), dtype=torch.float32, device=q.device)
    # the states entering every chunk, written by the state pass and read
    # by the output pass; freeing them on return is safe, as the caching
    # allocator hands their memory only to work queued later on this
    # stream
    scratch = torch.empty(scratch_floats(B, S, H, dp), dtype=torch.float32,
                          device=q.device)
    _LAUNCH(*(t.data_ptr() for t in (q, k, v, i_pre, f_pre, scratch, y)),
            B, S, H, Dh, dp, *q.stride()[:3], *i_pre.stride(),
            _DTYPE_CODE[q.dtype], _build.stream(q.get_device()))
    mlstm_chunk.launches += 1
    return y.reshape(B, S, H * Dh)


mlstm_chunk.launches = 0
