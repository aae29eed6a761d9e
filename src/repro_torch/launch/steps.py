"""The train step: gradients of ``LM.loss_fn`` by autograd, then AdamW.

Counterpart of ``repro.launch.steps.build_train_step`` without the
shardings: the LM takes the plan, whose constraints are the identity on
one card (placing tensors on a mesh is ROADMAP A8).  The step runs the plain
PyTorch paths, as the reference trains without its kernels: none of the
hand-written kernels has a backward pass, and their wrappers refuse a
gradient.  It runs on ``cuda`` unless the caller passes ``device="cpu"``.

    step = build_train_step(get_config("smollm-135m", smoke=True),
                            device="cpu")
    params, _ = step.lm.init(0)
    opt_state = step.opt.init(params)
    params, opt_state, metrics = step.fn(params, opt_state, batch)

``fn`` updates params and moments in place, as the reference's jitted
step donates them (``optim/adamw.py``).

On ``cuda``, as the reference jits its step, ``fn`` captures the whole
step (forward, remat recompute, backward, accumulation and the AdamW
update) in one CUDA graph at its first call (``launch/graphs.TrainGraph``)
and replays it: over the params and moments of that call, which it
updates where they lie, and batches of that call's shapes; another tree
or another shape raises.  ``graphs=False``, or ``device="cpu"``, runs the
step eagerly, operation by operation from the host; ``graphs=True`` on
the CPU runs the graph's step directly, against the same static buffers.
``grads`` always runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ArchConfig
from ..models.lm import LM
from ..optim import AdamW
from ..optim.adamw import tree_leaves, tree_unflatten
from .graphs import TrainGraph

F32 = torch.float32


@dataclass
class TrainStep:
    #: (params, opt_state, batch, lr_scale=1.0) → (params, opt_state,
    #: metrics); params and moments are updated in place (on a graph, the
    #: metrics are its static tensors, which the next call overwrites)
    fn: Callable
    #: (params, batch) → (grads, metrics): the gradient ``fn`` applies
    #: (accumulated over the micro-batches) and the metrics it returns
    grads: Callable
    lm: LM
    opt: AdamW


def _to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays or tensors → tensors on ``device``: integer entries
    (``tokens``, ``labels``) as int64, floating ones (``frames``,
    ``img_embeds``) as bf16, the cast the reference's ``LM._embed`` makes
    (``src/repro/models/lm.py:248-255``)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        dtype = torch.bfloat16 if t.is_floating_point() else torch.int64
        out[k] = t.to(device=device, dtype=dtype)
    return out


def build_train_step(cfg: ArchConfig, opt: AdamW | None = None,
                     remat: str = "full", use_kernels: bool = False,
                     accum_steps: int = 1,
                     device: torch.device | str = "cuda",
                     graphs: bool | None = None,
                     plan=None) -> TrainStep:
    """``accum_steps = K > 1`` splits the batch into K micro-batches along
    the batch axis (the reference's ``reshape((K, -1) + shape[1:])``),
    sums their gradients in f32 and divides by K, and applies one
    optimizer update; the metrics are the last micro-batch's, as the
    reference's scan carry returns them.  On a graph the K micro-batches
    are one graph, as the reference's ``lax.scan`` is one program.

    ``graphs``: ``None`` (the default) runs ``fn`` on a CUDA graph on
    ``cuda`` and eagerly on the CPU; ``True`` on a graph everywhere (its
    direct form on the CPU); ``False`` eagerly.

    The LM is built with ``graphs=False``: the sLSTM's own CUDA graph
    carries no gradients, and its loop is captured in the train step's.
    ``plan`` is the ``ShardingPlan`` the LM constrains under (``None``:
    none)."""
    if use_kernels:
        raise NotImplementedError(
            "build_train_step(use_kernels=True): the hand-written kernels "
            "carry no gradient and their wrappers refuse one; the train "
            "step runs the plain paths, as the reference's does")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    lm = LM(cfg, device=device, remat=remat, graphs=False, plan=plan)
    opt = opt or AdamW(moment_dtype=cfg.opt_moment_dtype)

    def loss_grads(params, leaves, batch):
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(tree_unflatten(params, leaves),
                                       batch)
            grads = torch.autograd.grad(loss, leaves,
                                        materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def grads_fn(params, batch):
        batch = _to_device(batch, lm.device)
        # fresh leaves of the caller's storage: autograd.grad returns the
        # gradients and leaves no .grad on the caller's tensors
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        if accum_steps == 1:
            grads, metrics = loss_grads(params, leaves, batch)
            return tree_unflatten(params, grads), metrics
        for k, v in batch.items():
            if v.shape[0] % accum_steps:
                raise ValueError(f"batch {k!r} of {v.shape[0]} rows does "
                                 f"not split into {accum_steps} "
                                 "micro-batches")
        micro = {k: v.reshape((accum_steps, -1) + v.shape[1:])
                 for k, v in batch.items()}
        gsum = [torch.zeros(p.shape, dtype=F32, device=p.device)
                for p in leaves]
        for i in range(accum_steps):
            g, metrics = loss_grads(params, leaves,
                                    {k: v[i] for k, v in micro.items()})
            for a, b in zip(gsum, g):
                a.add_(b)
        return tree_unflatten(params, [g / accum_steps for g in gsum]), \
            metrics

    def fn(params, opt_state, batch, lr_scale=1.0):
        grads, metrics = grads_fn(params, batch)
        params, opt_state = opt.update(grads, opt_state, params,
                                       lr_scale=lr_scale)
        return params, opt_state, metrics

    eager = TrainStep(fn, grads_fn, lm, opt)
    if graphs is False or (graphs is None and lm.device.type != "cuda"):
        return eager
    graph = None

    def graph_fn(params, opt_state, batch, lr_scale=1.0):
        nonlocal graph
        if graph is None:
            graph = TrainGraph(eager, params, opt_state,
                               _to_device(batch, lm.device))
        return graph.run(params, opt_state, batch, lr_scale)

    return TrainStep(graph_fn, grads_fn, lm, opt)
