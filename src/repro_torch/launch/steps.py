"""The train step: gradients of ``LM.loss_fn`` by autograd, then AdamW.

Counterpart of ``repro.launch.steps.build_train_step``: the LM takes the
plan, whose constraints redistribute DTensors under an ambient mesh and
are the identity on plain tensors.  ``sharding_tree`` maps a tree of
logical dims to the plan's layouts on a ``DeviceMesh`` (the reference's
``sharding_tree``), and ``distribute_tree`` places a param or cache tree
by them.  The step runs the plain PyTorch paths, as the reference
trains without its kernels: none of the hand-written kernels has a
backward pass, and their wrappers refuse a gradient.  It runs on
``cuda`` unless the caller passes ``device="cpu"``.

    step = build_train_step(get_config("smollm-135m", smoke=True),
                            device="cpu")
    params, _ = step.lm.init(0)
    opt_state = step.opt.init(params)
    params, opt_state, metrics = step.fn(params, opt_state, batch)

``fn`` updates params and moments in place, as the reference's jitted
step donates them (``optim/adamw.py``).

``batch_specs`` and ``input_specs`` give a cell's abstract inputs (meta
tensors of the reference's shapes and dtypes), and ``build_serve_step``
and ``build_prefill_step`` its serving steps under a plan on a mesh:
the dry-run's builders (``launch/dryrun.py``).

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
import torch.distributed as dist

from ..configs.base import ArchConfig, ShapeSpec
from ..models.lm import LM
from ..optim import AdamW
from ..optim.adamw import tree_leaves, tree_unflatten
from .graphs import TrainGraph
from .mesh import set_mesh

F32 = torch.float32
BF16 = torch.bfloat16


def _is_dims_leaf(x) -> bool:
    return (isinstance(x, tuple)
            and all(isinstance(i, str) for i in x)) or x == ()


def _map_tree(fn, tree, *rest, is_leaf):
    """``fn`` over the leaves of ``tree`` (dicts, tuples and NamedTuples;
    ``None`` stays ``None``), with the matching nodes of ``rest``."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map_tree(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def sharding_tree(dims_tree, mesh, plan, weight: bool = False,
                  shapes_tree=None):
    """Map a logical-dims tree to ``NamedSharding``s on ``mesh``: weight
    specs (FSDP included, given the leaves' shapes through
    ``shapes_tree``) with ``weight``, buffer specs otherwise."""
    def one(dims, leaf=None):
        shape = tuple(leaf.shape) if (leaf is not None and weight) else None
        return plan.named_sharding(mesh, dims, weight=weight, shape=shape)
    if shapes_tree is not None:
        return _map_tree(one, dims_tree, shapes_tree, is_leaf=_is_dims_leaf)
    return _map_tree(one, dims_tree, is_leaf=_is_dims_leaf)


def distribute_tree(tree, shardings):
    """Each full tensor of ``tree`` as a DTensor laid out by the matching
    ``NamedSharding`` of ``shardings`` (a ``sharding_tree``)."""
    return _map_tree(lambda x, sh: sh.distribute(x), tree, shardings,
                     is_leaf=torch.is_tensor)


# --------------------------------------------------------------------------
# Input specs: tensors on the meta device (shapes and dtypes, no memory)
# --------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """(specs, dims) for the data batch of one cell: the reference's
    shapes and dtypes, on the meta device."""
    B = shape.global_batch
    S = 1 if shape.mode == "decode" else shape.seq_len

    def meta(*size, dtype):
        return torch.empty(size, dtype=dtype, device="meta")
    specs: dict = {}
    dims: dict = {}
    if cfg.frontend == "audio_frames":
        specs["frames"] = meta(B, S, cfg.d_model, dtype=BF16)
        dims["frames"] = ("batch", "seq", "d_model")
    else:
        specs["tokens"] = meta(B, S, dtype=torch.int32)
        dims["tokens"] = ("batch", "seq")
    if cfg.frontend == "vision":
        specs["img_embeds"] = meta(B, cfg.n_img_tokens, cfg.d_model,
                                   dtype=BF16)
        dims["img_embeds"] = ("batch", "kv_seq", "d_model")
    if shape.mode == "train":
        specs["labels"] = meta(B, S, dtype=torch.int32)
        dims["labels"] = ("batch", "seq")
    if shape.mode == "decode":
        specs["pos"] = meta(dtype=torch.int32)
        dims["pos"] = ()
    return specs, dims


def input_specs(cfg: ArchConfig, shape: ShapeSpec, lm: LM | None = None
                ) -> dict:
    """All abstract inputs of the cell: the batch, the params and, for a
    decode cell, the caches."""
    lm = lm or LM(cfg, device="cpu")
    out = {"batch": batch_specs(cfg, shape)[0],
           "params": lm.init_abstract()[0]}
    if shape.mode == "decode":
        out["caches"] = lm.init_caches(shape.global_batch, shape.seq_len,
                                       abstract=True)
    return out


def _on_mesh(fn, mesh):
    """``fn`` run under ``set_mesh(mesh)``."""
    def run(*args, **kwargs):
        with set_mesh(mesh):
            return fn(*args, **kwargs)
    return run


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


def _average(grads, metrics: dict, group, world: int):
    """Gradients and metrics averaged over the ``world`` ranks of
    ``group``: one all-reduce of their f32 values, divided by ``world``,
    each cast back to its own dtype."""
    leaves = tree_leaves(grads)
    names = sorted(metrics)
    flat = torch.cat([g.reshape(-1).to(F32) for g in leaves]
                     + [metrics[k].reshape(1).to(F32) for k in names])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    avg = {k: flat[at + i].to(metrics[k].dtype) for i, k in enumerate(names)}
    return tree_unflatten(grads, out), avg


def build_train_step(cfg: ArchConfig, opt: AdamW | None = None,
                     remat: str = "full", use_kernels: bool = False,
                     accum_steps: int = 1,
                     device: torch.device | str = "cuda",
                     graphs: bool | None = None,
                     plan=None, data_group=None, mesh=None) -> TrainStep:
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
    none), and ``mesh`` the ``DeviceMesh`` its expert-parallel MoE path
    runs on (``None``: none, as the drivers build it).

    ``data_group``: the process group of the data axis.  Over W > 1
    ranks, each holding its shard of the batch and the same params,
    ``fn`` averages the gradients and the metrics over the group before
    the update, as the reference's step jitted over W devices computes
    them, and runs eagerly (``graphs=True`` raises: no collective is
    captured).  One rank, or ``None``, is the single-rank step."""
    if use_kernels:
        raise NotImplementedError(
            "build_train_step(use_kernels=True): the hand-written kernels "
            "carry no gradient and their wrappers refuse one; the train "
            "step runs the plain paths, as the reference's does")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    world = 1 if data_group is None else dist.get_world_size(data_group)
    if world > 1 and graphs:
        raise NotImplementedError(
            "build_train_step(graphs=True) over a data group of "
            f"{world} ranks: the all-reduce is not captured in the graph")
    lm = LM(cfg, device=device, remat=remat, graphs=False, plan=plan,
            mesh=mesh)
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
        if world > 1:
            grads, metrics = _average(grads, metrics, data_group, world)
        params, opt_state = opt.update(grads, opt_state, params,
                                       lr_scale=lr_scale)
        return params, opt_state, metrics

    eager = TrainStep(fn, grads_fn, lm, opt)
    if graphs is False or (graphs is None and (lm.device.type != "cuda"
                                               or world > 1)):
        return eager
    graph = None

    def graph_fn(params, opt_state, batch, lr_scale=1.0):
        nonlocal graph
        if graph is None:
            graph = TrainGraph(eager, params, opt_state,
                               _to_device(batch, lm.device))
        return graph.run(params, opt_state, batch, lr_scale)

    return TrainStep(graph_fn, grads_fn, lm, opt)


@dataclass
class ServeStep:
    #: (params, batch) → last-position logits, for a prefill cell
    prefill: Callable | None
    #: (params, batch, caches) → (logits, caches)
    decode: Callable
    #: (params, batch, caches) on the meta device
    abstract_inputs: tuple
    #: their layouts: ``sharding_tree``s to place them by
    #: (``distribute_tree``)
    shardings: tuple


def build_serve_step(cfg: ArchConfig, shape: ShapeSpec, mesh, plan,
                     use_kernels: bool = False,
                     device: torch.device | str = "cuda") -> ServeStep:
    """The serving steps of one cell under ``plan`` on ``mesh``: the LM's
    ``decode_step`` (and ``prefill`` for a prefill cell), each run under
    ``set_mesh(mesh)`` on inputs placed by ``shardings``, as the
    reference jits them with those in-shardings."""
    lm = LM(cfg, plan=plan, mesh=mesh, remat="none",
            use_kernels=use_kernels, device=device)
    params_abs, dims = lm.init_abstract()
    bspecs, bdims = batch_specs(cfg, shape)
    caches_abs = lm.init_caches(shape.global_batch, shape.seq_len,
                                abstract=True)
    shardings = (sharding_tree(dims, mesh, plan, weight=True,
                               shapes_tree=params_abs),
                 sharding_tree(bdims, mesh, plan),
                 sharding_tree(lm.cache_dims(), mesh, plan))
    prefill = (_on_mesh(lm.prefill, mesh) if shape.mode == "prefill"
               else None)
    return ServeStep(prefill, _on_mesh(lm.decode_step, mesh),
                     (params_abs, bspecs, caches_abs), shardings)


def build_prefill_step(cfg: ArchConfig, shape: ShapeSpec, mesh, plan,
                       use_kernels: bool = False,
                       device: torch.device | str = "cuda"):
    """(fn, (params, batch) on the meta device, their shardings): the
    LM's ``prefill`` under ``plan``, run under ``set_mesh(mesh)``."""
    lm = LM(cfg, plan=plan, mesh=mesh, remat="none",
            use_kernels=use_kernels, device=device)
    params_abs, dims = lm.init_abstract()
    bspecs, bdims = batch_specs(cfg, shape)
    shardings = (sharding_tree(dims, mesh, plan, weight=True,
                               shapes_tree=params_abs),
                 sharding_tree(bdims, mesh, plan))
    return _on_mesh(lm.prefill, mesh), (params_abs, bspecs), shardings
