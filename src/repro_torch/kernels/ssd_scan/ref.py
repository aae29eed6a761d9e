"""Plain PyTorch version of the selective-scan kernel: the sequential
recurrence ``h = exp(dt·A)⊙h + (dt·x)⊗B``, ``y = h·C`` in f32, which the
reference's oracle (``selective_scan_seq``) and the Pallas kernel's
``fori_loop`` both compute."""
from __future__ import annotations

import torch

from ...models.ssm import selective_scan_seq


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    y, _ = selective_scan_seq(x, dt, A, Bm, Cm)
    return y
