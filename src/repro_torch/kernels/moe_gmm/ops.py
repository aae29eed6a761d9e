"""Wrapper of the grouped expert matmul kernel.

``moe_gmm`` takes x ``(E, C, D)``, w ``(E, D, F)`` and the valid row
count of each expert, ``group_sizes`` ``(E,)``, and returns
``y[e] = x[e] @ w[e]`` with the rows at or past ``group_sizes[e]`` zeroed,
in x's dtype, as ``repro/kernels/moe_gmm/ops.py`` does.  On CPU tensors
it computes the plain version (``ref.moe_gmm_ref``).  On CUDA tensors it
launches ``csrc/moe_gmm.cu`` or raises; it never falls back.
``moe_gmm.launches`` counts kernel launches.

The kernel takes x and w of one dtype, bf16 (tensor cores) or f32 (CUDA
cores, full f32), with D and F multiples of 8.  Non-contiguous x or w are
copied; the model hands over contiguous buffers and weights (``w_in``
viewed as ``(E, D, 2·Fe)``).
"""
from __future__ import annotations

import torch

from .. import _build, refuse_grad
from .ref import moe_gmm_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


_LAUNCH = _build.Entry("moe_gmm", "moe_gmm_launch", "ppppiiiiip")


def moe_gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
            c_block: int = 128, f_block: int = 512,
            d_block: int = 512) -> torch.Tensor:
    """x (E,C,D) · w (E,D,F) with valid-row masking → (E,C,F) in x's dtype.

    Raises where the reference asserts: C, F and D must be multiples of
    ``min(c_block, C)``, ``min(f_block, F)`` and ``min(d_block, D)``.  The
    kernel's own tiles do not depend on the blocks named."""
    E, C, D = x.shape
    F = w.shape[-1]
    if C % min(c_block, C) or F % min(f_block, F) or D % min(d_block, D):
        raise ValueError(f"moe_gmm: C={C}, F={F}, D={D} must be multiples "
                         f"of the blocks {min(c_block, C)}, "
                         f"{min(f_block, F)}, {min(d_block, D)}")
    if w.shape != (E, D, F) or group_sizes.shape != (E,):
        raise ValueError(f"moe_gmm: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)}")
    refuse_grad("moe_gmm", x, w)
    if x.device.type == "cpu":
        return moe_gmm_ref(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    if w.device != x.device or group_sizes.device != x.device:
        raise ValueError("moe_gmm: inputs on different devices")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError("moe_gmm kernel takes bf16 or f32 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if D % 8 or F % 8:
        raise ValueError(f"moe_gmm kernel needs D and F multiples of 8, got "
                         f"D={D}, F={F}")
    if E > 65535:
        raise ValueError(f"moe_gmm kernel: E={E} exceeds the grid's 65535")
    # copies made here may be freed on return: the caching allocator hands
    # their memory only to work queued later on this stream
    x, w = x.contiguous(), w.contiguous()
    x, w = (t.clone() if t.data_ptr() % 16 else t for t in (x, w))
    gs = group_sizes.to(torch.int32).contiguous()
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    _LAUNCH(*(t.data_ptr() for t in (x, w, gs, y)), E, C, D, F,
            _DTYPE_CODE[x.dtype], _build.stream(x.get_device()))
    moe_gmm.launches += 1
    return y


moe_gmm.launches = 0
