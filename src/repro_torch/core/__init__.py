"""HIDA core: hierarchical dataflow IR + optimizer (the paper's
contribution), the port's copy of ``repro.core``.

The same modules under the same names, in plain Python and numpy: the IR,
the rewrite sessions, ``build_lm_graph``, the pre-DSE passes (construct,
fuse, lower, multi-producer elimination, balance), the hierarchical DSE,
``build_plan``, ``verify``, ``analyze``, ``optimize`` and the persistent
plan cache.  Given the same config and shape they derive the reference's
schedules and plans bit for bit (``tests/test_torch_core_*.py``), and a
plan cache written by either package is a hit for the other.  The cost
model keeps the reference's per-chip constants for that reason
(``estimator.py``, ``verify.py``).  ``generate.py`` builds the
``synth_*`` scale-stress graphs and ``pipeline.py`` holds the stage
analysis and the GPipe runtime (``PipelineConfig``, ``gpipe``: the stages
on one axis of a ``DeviceMesh``, microbatches passed around a ring of
point-to-point transfers).
"""
from .analyze import (AnalysisIssue, AnalysisRule, AnalyzeReport, analyze,
                      analyze_plan, register_rule, registered_rules)
from .balance import balance_paths
from .construct import construct_functional
from .estimator import (MULTI_POD, SINGLE_POD, MeshSpec, estimate,
                        roofline_terms)
from .faults import (FaultInjector, InjectedFault, active_injector,
                     fault_point, inject_faults)
from .fusion import fuse_tasks
from .generate import SYNTH_CONFIGS, SynthSpec, build_synth_graph, get_synth
from .graph import build_lm_graph
from .incremental import IncrementalEstimator
from .ir import (AccessMap, Buffer, Graph, GraphTopology, MemoryEffect, Node,
                 Op, Schedule, ScheduleTopology, Stream, TensorValue)
from .lower import fallback_schedule, lower_to_structural
from .multi_producer import eliminate_multi_producers
from .optimize import Degradation, OptimizeReport, optimize
from .parallelize import (RegionEntry, RegionSummary, best_uniform,
                          canonical_snapshot, parallelize)
from .plan import (PLAN_FORMAT_VERSION, ShardingPlan, build_plan,
                   project_rules, replicated_plan)
from .plan_cache import (CachedPlan, PlanCache, PlanKey, config_fingerprint,
                         fetch_or_optimize, shape_bucket)
from .rewrite import (GraphRewriteSession, RegionSpec, RewriteError,
                      ScheduleRewriteSession, default_region_bounds,
                      dse_regions, region_index_bytes)
from .verify import (VerifyError, VerifyIssue, VerifyReport, verify,
                     verify_static)

__all__ = [
    "AccessMap", "Buffer", "Graph", "GraphTopology", "MemoryEffect", "Node",
    "Op", "Schedule", "ScheduleTopology", "Stream", "TensorValue", "MeshSpec",
    "SINGLE_POD",
    "MULTI_POD", "estimate", "IncrementalEstimator", "roofline_terms",
    "construct_functional",
    "SYNTH_CONFIGS", "SynthSpec", "build_synth_graph", "get_synth",
    "fuse_tasks", "lower_to_structural", "eliminate_multi_producers",
    "balance_paths", "parallelize", "best_uniform", "ShardingPlan",
    "build_plan",
    "project_rules", "replicated_plan", "optimize", "OptimizeReport",
    "Degradation", "fallback_schedule",
    "build_lm_graph",
    "GraphRewriteSession", "ScheduleRewriteSession", "RewriteError",
    "RegionSpec", "dse_regions", "RegionSummary", "RegionEntry",
    "default_region_bounds", "region_index_bytes",
    "verify", "verify_static", "VerifyReport", "VerifyIssue", "VerifyError",
    "analyze", "analyze_plan", "AnalyzeReport", "AnalysisIssue",
    "AnalysisRule", "register_rule", "registered_rules",
    "inject_faults", "fault_point", "active_injector", "FaultInjector",
    "InjectedFault",
    "PlanKey", "PlanCache", "CachedPlan", "config_fingerprint",
    "shape_bucket", "fetch_or_optimize", "canonical_snapshot",
    "PLAN_FORMAT_VERSION",
]
