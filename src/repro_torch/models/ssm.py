"""Mamba selective-state-space block (Jamba's sequence mixer).

Counterpart of ``repro.models.ssm``, with the same parameter paths,
shapes and dtypes.  Three scans share one parameterisation:

* ``selective_scan_assoc`` — the whole sequence at once.  PyTorch has no
  ``associative_scan``, so the (decay, increment) pairs of the linear
  recurrence ``h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·x_t`` are combined by
  Hillis–Steele doubling over the time axis: log2(S) steps of
  ``(da·da', x + da·x')``.  It combines the same pairs as
  ``lax.associative_scan`` in another order, so it agrees with the step
  form to about 1e-5 in f32.
* ``selective_scan_chunked`` — a loop over chunks carrying the
  ``(B, Din, N)`` state, the doubling scan within each chunk: the
  full-sequence path without kernels.
* ``selective_scan_seq`` — the step form carrying the state; the decode
  path and the oracle.

With ``use_kernels`` the full-sequence path runs the selective-scan
kernel (``kernels/ssd_scan``); decode always runs the step form, as in
the reference.

``torch.nn.functional.softplus`` returns its input above 20, where
``jax.nn.softplus`` computes ``log1p(exp(-x)) + x``; the two differ there
by under 1e-8, which f32 cannot hold at such x.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import F32, ParamBuilder

Constrain = Callable[..., torch.Tensor]
DT_RANK_MIN = 8


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, D_in, N) f32


def dt_rank(cfg: ArchConfig) -> int:
    return max(DT_RANK_MIN, cfg.d_model // 16)


def init_mamba(pb: ParamBuilder, path: str, cfg: ArchConfig,
               stack: int | None = None) -> None:
    mb = cfg.mamba
    D = cfg.d_model
    Din = mb.expand * D
    N = mb.d_state
    R = dt_rank(cfg)
    pb.weight(f"{path}/w_in", (D, 2 * Din), ("d_model", "d_inner"),
              stack=stack)
    pb.weight(f"{path}/w_conv", (mb.d_conv, Din), ("d_conv", "d_inner"),
              scale=0.5, stack=stack)
    pb.weight(f"{path}/w_x", (Din, R + 2 * N), ("d_inner", "d_state"),
              stack=stack)
    pb.weight(f"{path}/w_dt", (R, Din), ("d_state", "d_inner"),
              stack=stack)
    # A is initialised to -[1..N] per channel (S4D-real init).
    pb.zeros(f"{path}/a_log", (Din, N), ("d_inner", "d_state"),
             dtype=F32, stack=stack)
    pb.ones(f"{path}/d_skip", (Din,), ("d_inner",), dtype=F32, stack=stack)
    pb.weight(f"{path}/w_out", (Din, D), ("d_inner", "d_model"),
              stack=stack)


def _discretize(x, dt, A, Bmat):
    """dA (B,S,Din,N) decay, dBx increment."""
    dA = torch.exp(dt[..., None] * A)                     # A < 0
    dBx = (dt * x)[..., None] * Bmat[:, :, None, :]
    return dA, dBx


def _scan_pairs(da: torch.Tensor, dx: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the pairs (da, dx) under
    ``(a, x) ∘ (b, y) = (a·b, y + b·x)``, by Hillis–Steele doubling."""
    k, S = 1, da.shape[1]
    while k < S:
        dx = torch.cat([dx[:, :k], dx[:, k:] + da[:, k:] * dx[:, :-k]], 1)
        da = torch.cat([da[:, :k], da[:, k:] * da[:, :-k]], 1)
        k *= 2
    return da, dx


def _read_out(h: torch.Tensor, Cmat: torch.Tensor) -> torch.Tensor:
    """``einsum("bsdn,bsn->bsd", h, C)``."""
    return (h @ Cmat[..., None]).squeeze(-1)


def selective_scan_assoc(x, dt, A, Bmat, Cmat):
    """x,dt (B,S,Din); A (Din,N); B,C (B,S,N) → y (B,S,Din) f32, parallel
    in S."""
    dA, dBx = _discretize(x.to(F32), dt.to(F32), A, Bmat.to(F32))
    _, h = _scan_pairs(dA, dBx)
    return _read_out(h, Cmat.to(F32))


def selective_scan_chunked(x, dt, A, Bmat, Cmat, chunk: int = 256):
    """Chunked form: a loop over chunks carrying the (B, Din, N) state,
    the doubling scan within each chunk.  The working set is
    (B, chunk, Din, N) f32 per chunk, as in the reference."""
    B_, S, Din = x.shape
    N = A.shape[-1]
    if S % chunk or S <= chunk:
        return selective_scan_assoc(x, dt, A, Bmat, Cmat)
    x, dt, Bmat, Cmat = (t.to(F32) for t in (x, dt, Bmat, Cmat))
    h = torch.zeros((B_, Din, N), dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dA, dBx = _discretize(x[:, sl], dt[:, sl], A, Bmat[:, sl])
        da_c, h_c = _scan_pairs(dA, dBx)
        h_full = h_c + da_c * h[:, None]      # carry-in contribution
        ys.append(_read_out(h_full, Cmat[:, sl]))
        h = h_full[:, -1]
    return torch.cat(ys, 1)


def selective_scan_seq(x, dt, A, Bmat, Cmat, h0=None):
    """Step-form oracle; also the decode path (S may be 1).  Returns
    (y, h_final)."""
    B_, S, Din = x.shape
    N = A.shape[-1]
    h = h0 if h0 is not None else torch.zeros((B_, Din, N), dtype=F32,
                                              device=x.device)
    x, dt, Bmat, Cmat = (t.to(F32) for t in (x, dt, Bmat, Cmat))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + (dt[:, t] * x[:, t])[..., None] * Bmat[:, t, None, :]
        ys.append((h @ Cmat[:, t, :, None]).squeeze(-1))
    return torch.stack(ys, 1), h


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d; ``carry`` ((B, k-1, Din)) for decode.
    The taps are summed in x's dtype, in the reference's order."""
    k = w.shape[0]
    if carry is not None:
        x = torch.cat([carry, x], dim=1)
        pad = 0
    else:
        pad = k - 1
    xp = F.pad(x, (0, 0, pad, 0)) if pad else x
    L = x.shape[1] - (0 if pad else k - 1)
    return sum(xp[:, i:i + L] * w[i] for i in range(k))


def mamba_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                constrain: Constrain,
                state: Optional[SSMState] = None,
                conv_carry: torch.Tensor | None = None,
                use_kernels: bool = False):
    """(B,S,D) → (B,S,D).  With ``state`` given, runs the step form and
    returns (y, new_state, new_conv_carry)."""
    mb = cfg.mamba
    D = cfg.d_model
    Din = mb.expand * D
    R = dt_rank(cfg)
    N = mb.d_state

    xz = x @ p["w_in"]
    xz = constrain(xz, ("batch", "seq", "d_inner"), "xz")
    xin, z = xz[..., :Din], xz[..., Din:]

    new_carry = None
    if state is not None:
        k = mb.d_conv
        cc = (conv_carry if conv_carry is not None
              else torch.zeros((x.shape[0], k - 1, Din), dtype=x.dtype,
                               device=x.device))
        xc = _causal_conv(xin, p["w_conv"], cc)
        new_carry = torch.cat([cc, xin], dim=1)[:, -(k - 1):]
    else:
        xc = _causal_conv(xin, p["w_conv"])
    xc = F.silu(xc.to(F32)).to(x.dtype)

    proj = xc @ p["w_x"]
    dt_r, Bmat, Cmat = (proj[..., :R], proj[..., R:R + N],
                        proj[..., R + N:])
    dt = F.softplus((dt_r @ p["w_dt"]).to(F32))
    A = -torch.exp(p["a_log"]) - torch.arange(
        1, N + 1, dtype=F32, device=x.device)[None, :]

    if state is not None:
        y, h = selective_scan_seq(xc, dt, A, Bmat, Cmat, state.h)
        new_state = SSMState(h)
    else:
        if use_kernels:
            from ..kernels.ssd_scan import ops as ssd_ops
            y = ssd_ops.ssd_scan(xc, dt, A, Bmat, Cmat, chunk=mb.chunk)
        else:
            y = selective_scan_chunked(xc, dt, A, Bmat, Cmat,
                                       chunk=mb.chunk)
        new_state = None
    y = y + xc.to(F32) * p["d_skip"]
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    y = constrain(y, ("batch", "seq", "d_inner"), "scan_out")

    out = y @ p["w_out"]
    if state is not None:
        return out, new_state, new_carry
    return out
