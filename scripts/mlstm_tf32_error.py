#!/usr/bin/env python3
"""How far single TF32 rounding would put the mLSTM kernel's output.

    python3 scripts/mlstm_tf32_error.py

A CPU emulation, no card needed.  The chunkwise mLSTM algorithm
(``kernels/mlstm_chunk/ref.py``) at the xlstm-125m prefill head shape
(4 heads of S=1024, Dh=384, chunk 64, bf16 inputs from seed 0) runs once
exactly in f32 and once with the f32 operand of a product rounded to
TF32 (10 mantissa bits, ties away), as a tensor-core product with one
TF32 operand would see it: the matrix memory C in q·C, the weights w in
w·v, and k·upd in the state update, each alone and all three.  Prints
the largest share of the kernel tolerance (2e-3 absolute and relative)
that any output uses: above 1, that product must carry its operand in
two TF32 parts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG = -1e30
TOL = 2e-3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest with ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(F32)


def mlstm(q, k, v, ip, fp, L, round_c=False, round_w=False, round_ku=False):
    BH, S, Dh = q.shape
    C = torch.zeros(BH, Dh, Dh)
    n = torch.zeros(BH, Dh)
    m_prev = torch.full((BH,), NEG)
    pos = torch.arange(L)
    causal = pos[None, :] <= pos[:, None]
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        qc, vc = q[:, sl].float(), v[:, sl].float()
        kc = k[:, sl].float() / Dh ** 0.5
        ic = ip[:, sl].float()
        Fc = torch.cumsum(F.logsigmoid(fp[:, sl].float()), 1)
        d = torch.where(causal, Fc[:, :, None] - Fc[:, None, :]
                        + ic[:, None, :], NEG)
        m_t = torch.maximum(m_prev[:, None] + Fc, d.amax(2))
        inter = torch.exp(m_prev[:, None] + Fc - m_t)
        w = (qc @ kc.transpose(1, 2)) * torch.exp(d - m_t[:, :, None])
        num = (tf32(w) if round_w else w) @ vc \
            + (qc @ (tf32(C) if round_c else C)) * inter[:, :, None]
        n_inter = (qc @ n[:, :, None])[:, :, 0] * inter
        den = torch.maximum(torch.abs(w.sum(2) + n_inter),
                            torch.exp(-m_t)) + 1e-6
        ys.append(num / den[:, :, None])
        m_new = m_t[:, -1]
        upd = torch.exp(Fc[:, -1:] - Fc + ic - m_new[:, None])
        decay = torch.exp(m_prev + Fc[:, -1] - m_new)
        ku = kc * upd[:, :, None]
        C = decay[:, None, None] * C \
            + (tf32(ku) if round_ku else ku).transpose(1, 2) @ vc
        n = decay[:, None] * n + ku.sum(1)
        m_prev = m_new
    return torch.cat(ys, 1)


def main() -> int:
    torch.manual_seed(0)
    BH, S, Dh, L = 4, 1024, 384, 64
    q, k, v = (torch.randn(BH, S, Dh).bfloat16() for _ in range(3))
    ip = torch.randn(BH, S).bfloat16()
    fp = (torch.randn(BH, S) + 2).bfloat16()
    exact = mlstm(q, k, v, ip, fp, L)
    for name, kw in (("C in q.C", dict(round_c=True)),
                     ("w in w.v", dict(round_w=True)),
                     ("k.upd in the update", dict(round_ku=True)),
                     ("all three", dict(round_c=True, round_w=True,
                                        round_ku=True))):
        y = mlstm(q, k, v, ip, fp, L, **kw)
        used = ((y - exact).abs() / (TOL + TOL * exact.abs())).max().item()
        print(f"TF32 rounding of {name}: {used:.2f} of the tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
