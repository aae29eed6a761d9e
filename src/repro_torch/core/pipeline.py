"""Stage analysis for HIDA's coarse-grained task pipeline.

The port's copy of the stage half of ``repro.core.pipeline``.  HIDA's
Structural schedule executes nodes as a pipeline whose initiation
interval is the critical node (Section 2 / 6.4); across pods the layer
stack is split into ``n_stages`` contiguous stages, balanced by HIDA node
intensities.  :func:`compute_stages` derives that mapping without touching
the schedule, :func:`apply_stages` writes it through one transactional
:class:`~repro_torch.core.rewrite.ScheduleRewriteSession`, and
:func:`assign_stages` does both.

The reference's GPipe runtime (``PipelineConfig`` and ``gpipe``:
microbatches rotating through the stages by ring transfers) needs
collectives across ranks and is not ported yet (ROADMAP A12).
"""
from __future__ import annotations

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
