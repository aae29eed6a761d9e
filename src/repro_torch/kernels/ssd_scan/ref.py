"""Plain PyTorch versions of the selective-scan kernel.

``ssd_scan_ref`` is the sequential recurrence ``h = exp(dt·A)⊙h +
(dt·x)⊗B``, ``y = h·C`` in f32, which the reference's oracle
(``selective_scan_seq``) and the Pallas kernel's ``fori_loop`` both
compute.  ``ssd_scan_kernel_order`` is the same recurrence in the order and
arithmetic of ``csrc/ssd_scan.cu``: the exponential as ``2^(dt·A·log2 e)``,
``exp2_poly`` (the kernel's software exponential) on the states the kernel
gives the FMA pipe, every fused multiply-add of the kernel rounded once,
and y summed over the states in order.
"""
from __future__ import annotations

import torch

from ...models.ssm import selective_scan_seq

F32 = torch.float32
LOG2E = 1.4426950408889634
#: exponentials on the FMA pipe per 32 states (``kPolyShare`` in the
#: kernel, which a test reads from its source): the last
#: ``N * POLY_SHARE // 32`` states of each half of a channel's states
POLY_SHARE = 2
#: q(f) of ``2^f = 1 + f·q(f)``, constant term first (the kernel's values)
EXP2_COEFFS = (0.6931467056274414, 0.24022187292575836, 0.05551047623157501,
               0.009674952365458012, 0.0013202981790527701)
_ROUND = 12582912.0   # 1.5 * 2^23


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    y, _ = selective_scan_seq(x, dt, A, Bm, Cm)
    return y


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``fmaf``: a·b + c rounded once to f32 (the f32 product is exact in
    f64, so only the sum's rounding to f64 can differ, and only in rare
    double-rounding ties)."""
    return (a.double() * b.double() + c).to(F32)


def exp2_poly(z: torch.Tensor) -> torch.Tensor:
    """2^z in f32 as the kernel computes it on the FMA pipe: z clamped to
    [-127, 127], split as j + f with j = rint(z) by adding and subtracting
    1.5·2^23, ``2^f = 1 + f·q(f)`` by Horner with every step one fused
    multiply-add, and j added into the exponent bits.  Largest relative
    error 1.90e-7 over [-126, 127]; below -126 the result lies in
    [0, 2^-126), and it is 0 for z <= -127."""
    z = z.to(F32).clamp(-127.0, 127.0)
    t = z + _ROUND
    f = z - (t - _ROUND)
    q = torch.full_like(f, EXP2_COEFFS[-1])
    for c in EXP2_COEFFS[-2::-1]:
        q = _fma(q, f, c)
    p = _fma(q, f, 1.0)
    j = (t - _ROUND).to(torch.int32)
    return (p.view(torch.int32) + j * (1 << 23)).view(F32)


def ssd_scan_kernel_order(x: torch.Tensor, dt: torch.Tensor,
                          A: torch.Tensor, Bm: torch.Tensor,
                          Cm: torch.Tensor) -> torch.Tensor:
    """x, dt (B,S,Din); A (Din,N); Bm, Cm (B,S,N) → y (B,S,Din) f32, step
    by step in the kernel's order.  It differs from the kernel only where
    ``ex2.approx`` and ``torch.exp2`` round differently (2 ulp at most)."""
    B, S, Din = x.shape
    N = A.shape[-1]
    half = N // 2
    poly = (torch.arange(N, device=x.device) % half
            >= half - N * POLY_SHARE // 32)
    a2 = A.to(F32) * LOG2E
    x, dt, Bm, Cm = (t.to(F32) for t in (x, dt, Bm, Cm))
    h = torch.zeros((B, Din, N), dtype=F32, device=x.device)
    ys = []
    for t in range(S):
        dv = dt[:, t, :, None]
        z = dv * a2
        e = torch.where(poly, exp2_poly(z), torch.exp2(z))
        dx = dt[:, t] * x[:, t]
        h = _fma(e, h, dx[..., None] * Bm[:, t, None, :])
        c = Cm[:, t, None, :].expand_as(h)
        acc = h[..., 0] * c[..., 0]
        for n in range(1, N):
            acc = _fma(h[..., n], c[..., n], acc)
        ys.append(acc)
    return torch.stack(ys, 1)
