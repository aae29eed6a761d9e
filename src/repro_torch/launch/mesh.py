"""Device meshes over ``torch.distributed``: the counterpart of
``repro.launch.mesh``.

``make_host_mesh`` builds a ``DeviceMesh`` over the ranks of the
initialised process group (one rank of its own where none exists),
``make_production_mesh`` the reference's 16x16 or 2x16x16 pod meshes,
``expert_mesh`` and ``expert_share`` the ``(world,)`` mesh and the
rank's share of the experts of expert-parallel serving, and
``set_mesh`` makes a mesh ambient to ``ShardingPlan.constrain``.
Every mesh here is a function's result, never a module-level constant,
so importing this module touches no process group.

    mesh = make_host_mesh(device="cpu")           # (world, 1)
    with set_mesh(mesh):
        ...                                        # plan.constrain redistributes

The backend is NCCL on ``cuda`` and gloo on ``cpu``; ``cuda`` without a
card raises, as every entry point of the port does.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from ..core.estimator import MULTI_POD, SINGLE_POD, MeshSpec
from ..core.plan import _MESHES

#: the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _ensure_group(device_type: str) -> None:
    """A process group whose backend serves ``device_type``: the
    initialised one, or a group of one rank on an in-memory store."""
    want = BACKENDS[device_type]
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    have = dist.get_backend()
    if want not in have:
        raise RuntimeError(f"the process group runs {have!r}; a "
                           f"{device_type} mesh needs {want!r}")


def make_host_mesh(shape: tuple[int, ...] | None = None,
                   axes: tuple[str, ...] = ("data", "model"),
                   device: str = "cuda"):
    """A mesh of ``shape`` (``None``: ``(world, 1)``) over the ranks of
    the process group, named ``axes``, on ``device``'s type."""
    device_type = torch.device(device).type
    if device_type not in BACKENDS:
        raise ValueError(f"no mesh on device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device='cuda'): no CUDA device "
                           "is available; pass device='cpu' for a gloo "
                           "mesh")
    _ensure_group(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(shape)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} over {axes} does not cover the "
                         f"{world} ranks of the process group")
    if device_type == "cuda":
        rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``;
    the world must hold exactly its 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return make_host_mesh(shape, axes, device=device)


def expert_mesh(device: str = "cuda"):
    """The ``(world,)`` mesh over ``("experts",)`` of expert-parallel
    serving: the process group's ranks, its group initialised from
    ``torchrun``'s environment first where there is none."""
    device_type = torch.device(device).type
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(BACKENDS[device_type])
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_host_mesh((world,), ("experts",), device=device)


def expert_share(mesh, axis: str = "experts"):
    """This rank's ``moe.ExpertShare`` over ``axis`` of ``mesh``: the
    ranks along it split every MoE layer's experts in order."""
    from ..models.moe import ExpertShare, axes_group, mesh_sizes
    group, order = axes_group(mesh, (axis,))
    return ExpertShare(group, mesh_sizes(mesh)[axis],
                       mesh.get_local_rank(axis), order)


def mesh_spec(multi_pod: bool = False) -> MeshSpec:
    return MULTI_POD if multi_pod else SINGLE_POD


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` ambient: inside, ``ShardingPlan.constrain``
    redistributes DTensors to their sites' placements on it, and a plain
    tensor that meets a DTensor in an operation (positions, masks, RoPE
    tables) is taken as replicated, as a constant is under the
    reference's ``jit``."""
    from torch.distributed.tensor.experimental import implicit_replication
    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()
