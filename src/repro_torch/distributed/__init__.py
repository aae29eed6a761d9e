"""Checkpointing, straggler policy, elastic re-stitching and re-planning:
the counterpart of ``repro.distributed``."""
from .checkpoint import CheckpointManager
from .elastic import (gather_full_tree, mesh_for_hosts, replan_for_topology,
                      reshard_checkpoint, scale_batch_schedule)
from .straggler import StragglerMonitor

__all__ = ["CheckpointManager", "gather_full_tree", "reshard_checkpoint",
           "mesh_for_hosts", "replan_for_topology", "scale_batch_schedule",
           "StragglerMonitor"]
