"""Plain PyTorch version of the grouped expert matmul: the reference's
``moe_gmm_ref``, an f32 batched product with the rows at or past
``group_sizes[e]`` zeroed, cast to x's dtype."""
from __future__ import annotations

import torch


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor) -> torch.Tensor:
    y = torch.bmm(x.to(torch.float32), w.to(torch.float32))
    C = x.shape[1]
    rows = torch.arange(C, device=x.device)[None, :, None]
    mask = rows < group_sizes.to(x.device)[:, None, None]
    return torch.where(mask, y, 0.0).to(x.dtype)
