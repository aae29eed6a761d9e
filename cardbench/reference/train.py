"""Plain PyTorch reference of the train step: the mean token
cross-entropy with its z-loss, gradients by autograd in float32 (one row
of the batch at a time, each layer recomputed in the backward pass so
that a row of thousands of tokens fits), and AdamW with a global-norm
clip, bias correction and decoupled weight decay.  Parameters keep the
dtype they are stored in (bfloat16 matrices, float32 norms); the update
is computed in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .model import Precision, Ref, cross_entropy

F32 = torch.float32


@dataclass(frozen=True)
class AdamWSpec:
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _layer(layer, resid, site, pos, groups):
    return checkpoint(layer, resid, site, pos, groups, use_reentrant=False)


def loss_and_grads(arch: dict, params: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, precision: str = Precision.F32,
                   rows: int | None = None) -> tuple[float, dict]:
    """(loss, {path: float32 gradient}) of the batch's mean loss.
    ``rows`` takes only the first ``rows`` rows (the half-batch fault)."""
    rows = rows or tokens.shape[0]
    leaves = {p: t.detach().to(F32).requires_grad_() for p, t in
              params.items()}
    ref = Ref(arch, leaves, precision)
    total = 0.0
    for b in range(rows):
        loss = cross_entropy(ref.forward(tokens[b:b + 1], layer_fn=_layer),
                             labels[b:b + 1]) / rows
        loss.backward()
        total += float(loss.detach())
    return total, {p: t.grad for p, t in leaves.items()}


class AdamWRef:
    """AdamW over float32 moments; ``update`` writes the new params in
    their own dtype."""

    def __init__(self, spec: AdamWSpec, params: dict):
        self.spec, self.t = spec, 0
        self.m = {p: torch.zeros_like(v, dtype=F32) for p, v in params.items()}
        self.v = {p: torch.zeros_like(v, dtype=F32) for p, v in params.items()}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> dict:
        """The clipped gradients the update used."""
        s = self.spec
        self.t += 1
        gn = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.clamp(s.grad_clip / (gn + 1e-9), max=1.0) \
            if s.grad_clip else 1.0
        c1, c2 = 1 - s.b1 ** self.t, 1 - s.b2 ** self.t
        used = {}
        for p, w in params.items():
            g = grads[p] * scale
            used[p] = g
            self.m[p] = s.b1 * self.m[p] + (1 - s.b1) * g
            self.v[p] = s.b2 * self.v[p] + (1 - s.b2) * g * g
            delta = (self.m[p] / c1) / (torch.sqrt(self.v[p] / c2) + s.eps)
            delta = delta + s.weight_decay * w.to(F32)
            w.copy_((w.to(F32) - s.lr * delta).to(w.dtype))
        return used


def train_readings(arch: dict, params: dict, batches: list,
                   spec: AdamWSpec, precision: str = Precision.F32,
                   rows: int | None = None) -> dict:
    """Follows ``len(batches)`` steps from ``params`` (updated in place):
    each step's loss, each leaf's norm of the first clipped gradient, and
    each leaf's norm of its change over all the steps."""
    start = {p: t.detach().to(F32).clone() for p, t in params.items()}
    opt = AdamWRef(spec, params)
    losses, grad_norms = [], None
    for tokens, labels in batches:
        loss, grads = loss_and_grads(arch, params, tokens, labels,
                                     precision, rows)
        used = opt.update(params, grads)
        losses.append(loss)
        if grad_norms is None:
            grad_norms = {p: float(g.norm()) for p, g in used.items()}
        del grads, used
    change = {p: float((params[p].to(F32) - start[p]).norm())
              for p in params}
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}
