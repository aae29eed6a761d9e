"""Plain PyTorch version of the flash attention kernel (mirrors
``repro/kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q (BH, G, Sq, Dh); k (BH, Skv, Dh); v (BH, Skv, Dv)."""
    BH, G, Sq, Dh = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) / math.sqrt(Dh)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return o.to(q.dtype)
