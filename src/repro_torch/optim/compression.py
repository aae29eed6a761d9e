"""Int8 error-feedback gradient compression for the data-parallel sync.

Counterpart of ``repro.optim.compression``, over the port's param trees
(nested dicts of tensors).  Each gradient leaf, plus the residual that
the last step's quantisation left, is quantised to int8 with one f32
scale per leaf (``max|x| / 127 + 1e-12``, round half to even, clipped
to ±127); the new residual is what the int8 payload lost, and is added
back into the next step's gradient.

``dp_allreduce_compressed`` models the wire as the reference does: an
all-reduce of the dequantized f32 payloads over the group, divided by
the group's size.  Sending the int8 payloads themselves is not modelled
(the reference does not either).  No driver calls it, as in the
reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .adamw import tree_leaves, tree_unflatten

F32 = torch.float32


class EFState(NamedTuple):
    residual: Any          # the grads' tree, f32


def init_ef_state(grads_like: Any) -> EFState:
    """Zero f32 residuals shaped like ``grads_like`` (on its leaves'
    devices: meta leaves give meta residuals)."""
    return EFState(tree_unflatten(grads_like, [
        torch.zeros(g.shape, dtype=F32, device=g.device)
        for g in tree_leaves(grads_like)]))


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g (+residual) → (int8 payload, f32 scale, new residual)."""
    x = g.to(F32) + residual
    # a tensor divisor: CUDA divides by a host scalar through its
    # reciprocal, one rounding more than the reference's division
    scale = x.abs().max() / x.new_tensor(127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.to(F32) * scale
    return q, scale, new_residual


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = F32) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def ef_compress_tree(grads: Any, state: EFState
                     ) -> tuple[Any, Any, EFState]:
    """Compress every leaf; returns (payloads, scales, new EF state)."""
    out = [compress(g, r) for g, r in zip(tree_leaves(grads),
                                           tree_leaves(state.residual))]
    q, s, r = ([o[i] for o in out] for i in range(3))
    return (tree_unflatten(grads, q), tree_unflatten(grads, s),
            EFState(tree_unflatten(grads, r)))


def ef_decompress_tree(q: Any, s: Any, dtype: torch.dtype = F32) -> Any:
    return tree_unflatten(q, [decompress(qi, si, dtype) for qi, si in
                              zip(tree_leaves(q), tree_leaves(s))])


def dp_allreduce_compressed(grads: Any, state: EFState, group=None
                            ) -> tuple[Any, EFState]:
    """The mean over ``group``'s ranks of each rank's compressed
    gradients, and this rank's new EF state: every leaf quantised with
    its residual, dequantized, all-reduced in f32 and divided by the
    group's size (the reference's ``psum`` of the dequantized payloads
    over the data axis)."""
    q, s, new_state = ef_compress_tree(grads, state)
    deq = tree_leaves(ef_decompress_tree(q, s))
    n = dist.get_world_size(group)
    for x in deq:
        dist.all_reduce(x, group=group)
    return tree_unflatten(grads, [x / n for x in deq]), new_state
