"""Plain PyTorch version of the mLSTM chunkwise kernel.

The algorithm of ``repro/kernels/mlstm_chunk/kernel.py`` (``_mlstm_kernel``)
with the batch·heads axis vectorised and the sequential chunk axis a
loop: per chunk, the intra-chunk decay-masked ``q kᵀ``, the read of the
carried matrix memory C and normaliser n, and the rank-L state update.
The stabiliser m is the exact running maximum of the decay matrix, so
the output does not depend on the chunk length beyond rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG = -1e30


def mlstm_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                    chunk: int = 128) -> torch.Tensor:
    """q,k,v (BH, S, Dh); i_pre,f_pre (BH, S) → y (BH, S, Dh) f32."""
    BH, S, Dh = q.shape
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"mlstm_chunk: S={S} is not a multiple of the "
                         f"chunk {L}")
    dev = q.device
    C = torch.zeros((BH, Dh, Dh), dtype=F32, device=dev)
    n = torch.zeros((BH, Dh), dtype=F32, device=dev)
    m_prev = torch.full((BH,), NEG, dtype=F32, device=dev)
    pos = torch.arange(L, device=dev)
    causal = pos[None, :] <= pos[:, None]                   # (t, s)
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        qc = q[:, sl].to(F32)                               # (BH, L, Dh)
        kc = k[:, sl].to(F32) / (Dh ** 0.5)                 # scale k only
        vc = v[:, sl].to(F32)
        ic = i_pre[:, sl].to(F32)                           # (BH, L)
        Fc = torch.cumsum(F.logsigmoid(f_pre[:, sl].to(F32)), dim=1)
        # D[t,s] = F_t - F_s + i_s for s <= t
        dmat = Fc[:, :, None] - Fc[:, None, :] + ic[:, None, :]
        dmat = torch.where(causal, dmat, NEG)
        m_t = torch.maximum(m_prev[:, None] + Fc, dmat.amax(dim=2))
        inter_decay = torch.exp(m_prev[:, None] + Fc - m_t)     # (BH, L)
        w = (qc @ kc.transpose(1, 2)) * torch.exp(dmat - m_t[:, :, None])
        num = w @ vc + (qc @ C) * inter_decay[:, :, None]
        n_inter = (qc @ n[:, :, None])[:, :, 0] * inter_decay
        denom = torch.maximum(torch.abs(w.sum(dim=2) + n_inter),
                              torch.exp(-m_t)) + 1e-6
        ys.append(num / denom[:, :, None])
        # state update to the end of the chunk
        m_new = m_t[:, -1]
        upd = torch.exp(Fc[:, -1:] - Fc + ic - m_new[:, None])  # (BH, L)
        decay_all = torch.exp(m_prev + Fc[:, -1] - m_new)       # (BH,)
        ku = kc * upd[:, :, None]
        C = decay_all[:, None, None] * C + ku.transpose(1, 2) @ vc
        n = decay_all[:, None] * n + ku.sum(dim=1)
        m_prev = m_new
    return torch.cat(ys, dim=1)


def mlstm_chunk_two_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i_pre: torch.Tensor, f_pre: torch.Tensor, *,
                         chunk: int = 64) -> torch.Tensor:
    """The CUDA kernel's blocking (``csrc/mlstm_chunk.cu``) in plain
    PyTorch: a state pass that carries C, n and m over the chunks and
    keeps the state entering each, then an output pass over every chunk
    at once from those states.  q,k,v (BH, S, Dh); i_pre,f_pre (BH, S) →
    y (BH, S, Dh) f32.  Any S: a ragged last chunk is zero-padded, which
    changes no valid step (its state is never needed)."""
    BH, S, Dh = q.shape
    L = chunk
    NC = -(-S // L)
    pad = NC * L - S

    def chunks(x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.to(F32), (0, 0, 0, pad) if x.dim() == 3 else (0, pad))
        return x.reshape(BH, NC, L, *x.shape[2:])
    qc, kc, vc = chunks(q), chunks(k) / (Dh ** 0.5), chunks(v)
    ic = chunks(i_pre)
    Fc = torch.cumsum(chunks(F.logsigmoid(f_pre.to(F32))), dim=2)
    # state pass: the state entering chunk c, for every c
    C = torch.zeros((BH, Dh, Dh), dtype=F32, device=q.device)
    n = torch.zeros((BH, Dh), dtype=F32, device=q.device)
    m = torch.full((BH,), NEG, dtype=F32, device=q.device)
    Cs, ns, ms = [C], [n], [m]
    for c in range(NC - 1):
        F_last = Fc[:, c, -1]
        m_new = torch.maximum(
            m + F_last, (F_last[:, None] - Fc[:, c] + ic[:, c]).amax(dim=1))
        decay = torch.exp(m + F_last - m_new)
        upd = torch.exp(F_last[:, None] - Fc[:, c] + ic[:, c]
                        - m_new[:, None])
        ku = kc[:, c] * upd[:, :, None]
        C = decay[:, None, None] * C + ku.transpose(1, 2) @ vc[:, c]
        n = decay[:, None] * n + ku.sum(dim=1)
        m = m_new
        Cs.append(C)
        ns.append(n)
        ms.append(m)
    Cs, ns, ms = torch.stack(Cs, 1), torch.stack(ns, 1), torch.stack(ms, 1)
    # output pass: every chunk from the state entering it
    pos = torch.arange(L, device=q.device)
    causal = pos[None, :] <= pos[:, None]
    dmat = Fc[..., :, None] - Fc[..., None, :] + ic[..., None, :]
    dmat = torch.where(causal, dmat, NEG)
    m_t = torch.maximum(ms[..., None] + Fc, dmat.amax(dim=-1))
    inter = torch.exp(ms[..., None] + Fc - m_t)
    w = (qc @ kc.transpose(-1, -2)) * torch.exp(dmat - m_t[..., None])
    num = w @ vc + (qc @ Cs) * inter[..., None]
    n_inter = (qc @ ns[..., None])[..., 0] * inter
    denom = torch.maximum(torch.abs(w.sum(dim=-1) + n_inter),
                          torch.exp(-m_t)) + 1e-6
    y = num / denom[..., None]
    return y.reshape(BH, NC * L, Dh)[:, :S]
