"""Shared layers: norms, SwiGLU MLP, rotary embeddings, parameter builder.

Counterpart of ``repro.models.layers``.  Parameters are plain nested
dicts of tensors with the reference's paths and layouts; ``ParamBuilder``
records each parameter's logical dims beside it, as the reference does
for plan-driven sharding.

Numerics follow the reference op for op: norms and the SiLU run in f32
and cast back to the activation dtype; bf16 products accumulate in f32
and round once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from ..core.plan import logsumexp_and_take, project

BF16 = torch.bfloat16
F32 = torch.float32
#: the most f32 values ``ParamBuilder`` draws at once (256 MiB)
_DRAW_CHUNK = 1 << 26


# --------------------------------------------------------------------------
# Parameter builder (records logical dims for plan-driven sharding)
# --------------------------------------------------------------------------

@dataclass
class ParamBuilder:
    """Initialises parameters at the reference's stds (``1/sqrt(fan_in)``
    unless a scale is given; norms at ones/zeros).  Only shapes and stds
    match the reference: its values cross through ``repro_torch.bridge``.

    ``device="meta"`` records shapes and dtypes without allocating."""
    generator: torch.Generator | None
    device: torch.device = torch.device("cpu")
    params: dict = field(default_factory=dict)
    dims: dict = field(default_factory=dict)

    def weight(self, path: str, shape: Sequence[int], dims: Sequence[str],
               dtype=BF16, scale: float | None = None,
               stack: int | None = None,
               generator: torch.Generator | None = None) -> None:
        """Register a weight; ``stack`` prepends a layer-stack axis
        (dims gets a leading "layers"); ``generator`` draws it in place of
        the builder's own."""
        gen = self.generator if generator is None else generator
        shape = tuple(shape)
        fan_in = shape[0] if shape else 1
        std = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        full = (stack,) + shape if stack else shape
        full_dims = (("layers",) + tuple(dims)) if stack else tuple(dims)
        if self.device.type == "meta":
            leaf = torch.empty(full, dtype=dtype, device=self.device)
        elif np.prod(full) <= _DRAW_CHUNK:
            leaf = (torch.randn(full, generator=gen, dtype=F32,
                                device=self.device) * std).to(dtype)
        else:
            # drawn in f32 pieces, so a leaf of billions of elements (an
            # expert stack) needs no f32 copy of itself
            leaf = torch.empty(full, dtype=dtype, device=self.device)
            flat = leaf.view(-1)
            for i in range(0, flat.numel(), _DRAW_CHUNK):
                n = min(_DRAW_CHUNK, flat.numel() - i)
                flat[i:i + n] = torch.randn(
                    n, generator=gen, dtype=F32, device=self.device) * std
        _set(self.params, path, leaf)
        _set(self.dims, path, full_dims)

    def _const(self, value: float, path, shape, dims, dtype, stack):
        full = ((stack,) + tuple(shape)) if stack else tuple(shape)
        full_dims = (("layers",) + tuple(dims)) if stack else tuple(dims)
        if self.device.type == "meta":
            leaf = torch.empty(full, dtype=dtype, device=self.device)
        else:
            leaf = torch.full(full, value, dtype=dtype, device=self.device)
        _set(self.params, path, leaf)
        _set(self.dims, path, full_dims)

    def ones(self, path: str, shape: Sequence[int], dims: Sequence[str],
             dtype=F32, stack: int | None = None) -> None:
        self._const(1.0, path, shape, dims, dtype, stack)

    def zeros(self, path: str, shape: Sequence[int], dims: Sequence[str],
              dtype=F32, stack: int | None = None) -> None:
        self._const(0.0, path, shape, dims, dtype, stack)


def _set(tree: dict, path: str, leaf: Any) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def tree_get(tree: dict, path: str) -> Any:
    for k in path.split("/"):
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * scale.to(F32)
    return y.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(F32) + bias.to(F32)
    return y.to(dtype)


def apply_norm(kind: str, x: torch.Tensor, p: dict,
               use_kernels: bool = False) -> torch.Tensor:
    """``use_kernels`` routes RMS norms through the hand-written kernel
    (``kernels/rmsnorm``), which computes exactly ``rms_norm``."""
    if kind == "rms":
        if use_kernels:
            from ..kernels.rmsnorm import ops as rms_ops
            return rms_ops.rmsnorm(x, p["scale"])
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(pb: ParamBuilder, path: str, kind: str, d: int,
              stack: int | None = None) -> None:
    pb.ones(f"{path}/scale", (d,), ("d_model",), stack=stack)
    if kind != "rms":
        pb.zeros(f"{path}/bias", (d,), ("d_model",), stack=stack)


# --------------------------------------------------------------------------
# Rotary position embeddings (with partial-rotary support)
# --------------------------------------------------------------------------

#: (rot_dim, base, device), with YaRN's parameters after it where given →
#: the f32 inverse frequencies on that device
_INV_FREQ: dict[tuple, torch.Tensor] = {}


def yarn_inv_freq(rot_dim: int, base: float, yarn: tuple) -> np.ndarray:
    """YaRN's inverse frequencies in float64 (arXiv:2309.00071; the
    published DeepSeek-V2 code): ``yarn`` is (factor, original context,
    beta_fast, beta_slow, ...), any further entries read elsewhere.  Each
    frequency is blended between its extrapolated value ``base^(-2i/d)``
    and its interpolated value, that over ``factor``, by a ramp over the
    pair index ``i`` from the pair that turns ``beta_fast`` times over the
    original context (and every faster one: extrapolated) to the one that
    turns ``beta_slow`` times (and every slower one: interpolated)."""
    factor, orig, fast, slow = yarn[:4]

    def pair_of(turns):
        return rot_dim * math.log(orig / (turns * 2 * math.pi)) \
            / (2 * math.log(base))
    lo = max(math.floor(pair_of(fast)), 0)
    hi = min(math.ceil(pair_of(slow)), rot_dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = np.clip((np.arange(rot_dim // 2, dtype=np.float64) - lo)
                   / (hi - lo), 0.0, 1.0)
    extra = 1.0 / (base ** (np.arange(0, rot_dim, 2) / rot_dim))
    return extra / factor * ramp + extra * (1.0 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1·mscale·ln(factor) + 1`` (1 where
    ``factor`` <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _inv_freq(rot_dim: int, base: float, device: torch.device,
              yarn: tuple | None = None) -> torch.Tensor:
    """The inverse frequencies, built once per (rot_dim, base, yarn,
    device): a copy from the host inside a decode step would stall it,
    and a CUDA graph capture refuses one."""
    key = (rot_dim, base, device) if yarn is None else \
        (rot_dim, base, device, yarn)
    inv_t = _INV_FREQ.get(key)
    if inv_t is None:
        inv = (1.0 / (base ** (np.arange(0, rot_dim, 2) / rot_dim))
               if yarn is None else yarn_inv_freq(rot_dim, base, yarn))
        inv_t = torch.tensor(inv, dtype=F32, device=device)
        if not is_fake(inv_t):
            # a fake tensor (the dry-run's) lives only as long as its mode
            _INV_FREQ[key] = inv_t
    return inv_t


def rope_angles(positions: torch.Tensor, rot_dim: int,
                base: float = 10000.0, yarn: tuple | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) → cos/sin (..., S, rot_dim//2).  The inverse
    frequencies come from numpy in float64, as in the reference, and the
    product with the positions is taken in f32.  ``yarn`` (see
    :func:`yarn_inv_freq`) gives YaRN's frequencies."""
    ang = positions[..., None].to(F32) * _inv_freq(rot_dim, base,
                                                   positions.device, yarn)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x (B,S,H,Dh); rotate the first ``rot_dim`` features, pass the rest
    through.  The pairs are interleaved (``0::2`` with ``1::2``), not
    split in halves."""
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    r1, r2 = rot[..., 0::2], rot[..., 1::2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    o1 = r1 * cos - r2 * sin
    o2 = r2 * cos + r1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(rot.shape)
    return torch.cat([out.to(x.dtype), rest], dim=-1)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def init_mlp(pb: ParamBuilder, path: str, d: int, d_ff: int,
             stack: int | None = None) -> None:
    pb.weight(f"{path}/w_in", (d, 2, d_ff), ("d_model", "two", "d_ff"),
              stack=stack)
    pb.weight(f"{path}/w_out", (d_ff, d), ("d_ff", "d_model"), stack=stack)


def mlp(x: torch.Tensor, p: dict, constrain=lambda t, d, s=None: t
        ) -> torch.Tensor:
    h = project(x, p["w_in"], 1, constrain, ("batch", "seq", None, "d_ff"),
                "ffn_hidden")
    gate, up = h[..., 0, :], h[..., 1, :]
    act = F.silu(gate.to(F32)).to(x.dtype) * up
    return project(act, p["w_out"])


# --------------------------------------------------------------------------
# Loss (a stable logsumexp, no host gather)
# --------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy in f32, plus ``z_loss`` times the mean
    squared logsumexp (router-style logit regularisation).  The max is
    taken without a gradient, as the reference's ``stop_gradient``."""
    lse, gold = logsumexp_and_take(logits.to(F32), labels[..., None].long())
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
