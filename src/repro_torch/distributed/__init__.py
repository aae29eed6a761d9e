"""Checkpointing, straggler policy and elastic re-stitching: the
counterpart of ``repro.distributed``, less ``mesh_for_hosts`` and
``replan_for_topology``, which wait for the device mesh (ROADMAP A8) and
A14's rest."""
from .checkpoint import CheckpointManager
from .elastic import gather_full_tree, reshard_checkpoint, scale_batch_schedule
from .straggler import StragglerMonitor

__all__ = ["CheckpointManager", "gather_full_tree", "reshard_checkpoint",
           "scale_batch_schedule", "StragglerMonitor"]
