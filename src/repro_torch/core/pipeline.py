"""Stage analysis for HIDA's coarse-grained task pipeline.

The port's copy of the stage half of ``repro.core.pipeline``.  HIDA's
Structural schedule executes nodes as a pipeline whose initiation
interval is the critical node (Section 2 / 6.4); across pods the layer
stack is split into ``n_stages`` contiguous stages, balanced by HIDA node
intensities.  :func:`compute_stages` derives that mapping without touching
the schedule, :func:`apply_stages` writes it through one transactional
:class:`~repro_torch.core.rewrite.ScheduleRewriteSession`, and
:func:`assign_stages` does both.

The GPipe runtime (``PipelineConfig`` and :func:`gpipe`) runs the
stages on the ranks of one axis of a ``torch.distributed`` ``DeviceMesh``:
microbatches enter at stage 0 and rotate around the ring of stages by
point-to-point transfers (the reference's ``ppermute``), and the last
stage's outputs are summed over the stage group (its masked ``psum``),
so that every rank returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from ..optim.adamw import tree_leaves, tree_unflatten
from .ir import Schedule


def compute_stages(sched: Schedule, n_stages: int) -> dict[str, int]:
    """Pure stage analysis: balance HIDA nodes across pipeline stages by
    intensity (the critical-node II is what the paper's fusion pass
    already minimised).  Returns ``node name -> stage`` without touching
    the schedule — apply with :func:`apply_stages`."""
    order = sched.topo_order()
    total = sum(n.intensity() for n in order) or 1
    target = total / n_stages
    acc, stage = 0.0, 0
    out: dict[str, int] = {}
    for n in order:
        out[n.name] = stage
        acc += n.intensity()
        if acc >= target * (stage + 1) and stage < n_stages - 1:
            stage += 1
    return out


def apply_stages(sched: Schedule, stages: dict[str, int]) -> None:
    """Write a stage mapping onto the schedule through one transactional
    :class:`~repro_torch.core.rewrite.ScheduleRewriteSession` — either
    every node's ``stage`` is updated or (on error) none is, so callers
    can never observe a half-applied mapping."""
    from .rewrite import ScheduleRewriteSession
    with ScheduleRewriteSession(sched) as rs:
        for name, stage in stages.items():
            rs.set_stage(sched.node(name), stage)


def assign_stages(sched: Schedule, n_stages: int) -> dict[str, int]:
    """:func:`compute_stages` + :func:`apply_stages` in one step: the
    mutation is an all-or-nothing rewrite applied only after the analysis
    completes."""
    stages = compute_stages(sched, n_stages)
    apply_stages(sched, stages)
    return stages


@dataclass
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    stage_axis: str = "pod"


def _ring(y: torch.Tensor, group, rank: int, size: int) -> torch.Tensor:
    """``y`` sent to the next rank of ``group`` and the previous rank's
    received: one step of the ring.  One rank keeps its own (NCCL may
    refuse a send to itself)."""
    if size == 1:
        return y.clone()
    y = y.contiguous()
    got = torch.empty_like(y)
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, y, nxt, group),
            dist.P2POp(dist.irecv, got, prv, group)]):
        work.wait()
    return got


def gpipe(stage_fn: Callable, cfg: PipelineConfig, mesh, in_spec=None,
          out_spec=None):
    """Build a GPipe-style pipelined forward: ``stage_fn(params, x,
    stage)`` is one stage's computation; microbatches rotate through the
    stages of ``mesh``'s ``cfg.stage_axis`` (one stage a rank) by ring
    transfers, the HIDA ``stream`` between schedule nodes.

    Returns ``run(stacked_stage_params, microbatches)``: the params'
    leaves (a tensor or a dict of them) have a leading dim of
    ``n_stages``, of which each rank takes its own stage's slice (a
    ``DTensor`` sharded on that dim holds it as its local block); the
    microbatches ``(n_microbatches, ...)`` are replicated.  Every rank
    returns the last stage's ``(n_microbatches, ...)`` outputs.
    ``in_spec`` and ``out_spec`` are the reference's arguments, which
    it does not read either.  Forward only: the ring transfers carry no
    gradient."""
    from torch.distributed.tensor import DTensor
    S, M = cfg.n_stages, cfg.n_microbatches
    axis = cfg.stage_axis
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    if mesh.size(mesh.mesh_dim_names.index(axis)) != S:
        raise ValueError(f"the {axis!r} axis of {mesh} holds "
                         f"{mesh.size(mesh.mesh_dim_names.index(axis))} "
                         f"ranks, not {S} stages")

    def local(t, i=None):
        if isinstance(t, DTensor):
            t = t.to_local()
            return t if i is None else t[0]
        return t if i is None else t[i]

    def run(stage_params, microbatches):
        params = tree_unflatten(stage_params, [
            local(p, stage) for p in tree_leaves(stage_params)])
        mb = local(microbatches)
        state = torch.zeros_like(mb[0])            # the ring slot
        outs = None
        for t in range(M + S - 1):
            # stage 0 injects microbatch t; the others consume the slot
            x = mb[t] if (stage == 0 and t < M) else state
            y = stage_fn(params, x, stage)
            if outs is None:
                outs = y.new_zeros((M,) + tuple(y.shape))
            # the last stage writes its completed microbatch
            if stage == S - 1 and 0 <= t - stage < M:
                outs[t - stage] = y
            state = _ring(y, group, stage, S)
        # only the last stage holds real outputs: share them
        dist.all_reduce(outs, group=group)
        return outs

    return run
