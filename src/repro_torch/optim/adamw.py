"""AdamW over the port's param trees (nested dicts of tensors).

Counterpart of ``repro.optim.adamw``: the same defaults, global-norm
clip, bias correction and decoupled weight decay, the update math in f32,
params kept in their storage dtype and moments in ``moment_dtype`` (f32,
or bf16 as deepseek-v3's config selects).

The reference's jitted step donates params and moments.  Here ``update``
likewise writes the new params and moments into the tensors it is given,
under ``torch.no_grad()``, and returns them: a caller that needs the old
values clones them first.  The step counter advances in place too, so
the state returned is the state given, and a CUDA graph of the update
(``launch/graphs.TrainGraph``) reads and advances the same counter at
every replay.  ``step``, the gradient norm, the clip scale and
``lr_scale`` stay on the device, so an update makes no host sync.
The elementwise update runs over slices of each leaf along its first
axis (``_row_slices``), so its f32 temporaries stay near a GB whatever
the leaf's size (musicgen-large's stacked ``ffn/w_in`` is 1.61 B
elements, 6.4 GB for each f32 temporary of it whole); each element's
arithmetic is the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..core.plan import local, relayout

F32 = torch.float32
#: elements of a leaf that one slice of the update covers (at least one
#: row along the first axis)
_SLICE = 1 << 26


def _row_slices(t: torch.Tensor):
    """Index expressions covering ``t`` in slices of its first axis of
    about ``_SLICE`` elements each (``...`` for a scalar)."""
    if t.ndim == 0:
        yield ...
        return
    rows = max(1, _SLICE // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order, the order of
    ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves: list):
    """A nested dict shaped like ``like`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32, on the params' device
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "f32"
    grad_clip: float = 1.0

    @property
    def _mdt(self) -> torch.dtype:
        return torch.bfloat16 if self.moment_dtype == "bf16" else F32

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)

        def zeros():
            # a DTensor param's moments are DTensors of its layout
            return tree_unflatten(params, [
                torch.zeros_like(p, dtype=self._mdt) for p in leaves])
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        return AdamWState(step, zeros(), zeros())

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               lr_scale: torch.Tensor | float = 1.0):
        """Returns (params, state), the very objects given, updated in
        place (see the module docstring).  Update math in f32; params keep
        their storage dtype."""
        step = state.step.add_(1)
        gs = tree_leaves(grads)
        # global-norm clip
        if self.grad_clip:
            gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                                for g in gs))
            scale = local(torch.clamp(self.grad_clip / (gn + 1e-9),
                                      max=1.0))
        else:
            scale = 1.0
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.to(F32)
        c2 = 1.0 - b2 ** step.to(F32)
        lr = self.lr * lr_scale
        for g_all, m_all, v_all, p_all in zip(
                gs, tree_leaves(state.mu), tree_leaves(state.nu),
                tree_leaves(params), strict=True):
            # elementwise: under a mesh each rank updates its own blocks
            g_all = relayout(g_all, "like", p_all)
            g_all, m_all, v_all, p_all = (
                local(t) for t in (g_all, m_all, v_all, p_all))
            for i in _row_slices(p_all):
                g, m, v, p = g_all[i], m_all[i], v_all[i], p_all[i]
                g = g.to(F32) * scale
                m32 = b1 * m.to(F32) + (1 - b1) * g
                v32 = b2 * v.to(F32) + (1 - b2) * torch.square(g)
                delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
                if self.weight_decay:
                    delta = delta + self.weight_decay * p.to(F32)
                p.copy_(p.to(F32) - lr * delta)
                m.copy_(m32)
                v.copy_(v32)
        return params, state


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[Any], torch.Tensor]:
    """step → the lr scale: linear warm-up over ``warmup`` steps, then a
    cosine from 1 to 0 at ``total``, in f32 (on the step's device where
    the step is a tensor).  ``base_lr`` is unused, as in the reference."""
    def f(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return f
