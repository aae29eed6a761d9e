"""HIDA-OPT driver: the paper's five-step pipeline (Section 6).

``optimize(graph, mesh)`` runs

    construct (Alg.1) → task fusion (Alg.2) → Functional→Structural
    lowering (§6.3) → multi-producer elimination (Alg.3) → data-path
    balancing (§6.4.2) → IA+CA parallelization (Alg.4/§6.5)

and returns the parallelized ``Schedule``, the derived ``ShardingPlan``
and a pass-by-pass report.  The ablation switches (``ia``, ``ca``,
``fuse``) reproduce the paper's Fig. 11 arms.

``optimize()`` is **total**: every pass boundary is an error boundary.
The structural passes run inside transactional rewrite sessions
(:mod:`repro_torch.core.rewrite`) that roll back on exception, so a failed
pass leaves its input IR intact and the pipeline continues on the
unrewritten graph/schedule; a failed lowering falls back to the
single-node :func:`~repro_torch.core.lower.fallback_schedule`; a failed or
over-budget DSE falls back to its converged-greedy snapshot and then to
the uniform-assignment family
(:func:`~repro_torch.core.parallelize.best_uniform`); a failed plan
derivation falls back to a full coherent rebuild and then to
:func:`~repro_torch.core.plan.replicated_plan`.  Every fallback taken is
recorded in :attr:`OptimizeReport.degradations`, and the returned plan
is checked by the independent :func:`~repro_torch.core.verify.verify` — with
its own repair rungs — before it leaves this function.  The chaos sweep
in ``tests/test_faults.py`` drives every rung via
:mod:`repro_torch.core.faults`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from .analyze import AnalyzeReport, analyze
from .balance import BalanceStats, balance_paths
from .construct import construct_functional
from .estimator import MeshSpec, ScheduleCost, estimate
from .faults import active_injector
from .fusion import FusionStats, fuse_tasks
from .incremental import Snapshot
from .ir import Graph, Schedule, topology_index_bytes
from .lower import fallback_schedule, lower_to_structural
from .multi_producer import MultiProducerStats, eliminate_multi_producers
from .parallelize import ParallelizeResult, best_uniform, parallelize
from .plan import (ShardingPlan, build_plan, project_rules,
                   replicated_plan)
from .rewrite import dse_regions
from .verify import VerifyReport, verify


def _exc(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def _floor_regions(sched: Schedule):
    """Region partition for the region-aware QoR floor — best-effort:
    the floor must stay serviceable even when the topology is the thing
    that broke, so any partition failure degrades to the whole-schedule
    floor (``regions=None``) instead of raising."""
    try:
        regs = dse_regions(sched)
        return regs if len(regs) > 1 else None
    except Exception:
        return None


@dataclass(frozen=True)
class Degradation:
    """One rung of the degradation ladder that actually fired."""
    stage: str    # construct | fuse | lower | mp | balance | dse |
    #               qor-floor | plan | verify
    action: str   # what the ladder did instead
    error: str = ""  # the triggering exception / verifier codes

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        tail = f" [{self.error}]" if self.error else ""
        return f"{self.stage}: {self.action}{tail}"


@dataclass
class OptimizeReport:
    fusion: FusionStats | None = None
    multi_producer: MultiProducerStats | None = None
    balance: BalanceStats | None = None
    parallelize: ParallelizeResult | None = None
    cost: ScheduleCost | None = None
    compile_time_s: float = 0.0
    #: wall time of plan derivation (build_plan + EP widening + role
    #: aliasing) — tracked by benchmarks/bench_compile_time.py.
    plan_time_s: float = 0.0
    #: per-pass wall time of the pre-DSE pipeline (all five passes —
    #: construction included — run on the transactional rewrite
    #: substrate; benchmarks/bench_compile_time gates their total, and
    #: ``fuse_s`` specifically, so a topology- or reachability-index
    #: maintenance regression is caught the same way a DSE regression is).
    construct_s: float = 0.0
    fuse_s: float = 0.0
    lower_s: float = 0.0
    mp_s: float = 0.0
    balance_s: float = 0.0
    #: wall time of the exit legality check (verify + any repair rungs);
    #: benchmarks/bench_compile_time gates it staying ≪ pre_dse_s.
    verify_s: float = 0.0
    #: wall time of the exit static hazard analysis
    #: (:func:`repro_torch.core.analyze.analyze`) — gated by
    #: benchmarks/bench_compile_time like ``verify_s``.
    analyze_s: float = 0.0
    #: per-level DSE wall time (hierarchical mode: inner = per-region
    #: searches, outer = inter-region composition; both 0.0 on the flat
    #: path) and the number of regions the schedule was partitioned into
    #: — benchmarks/bench_compile_time reports all three per arm.
    inner_dse_s: float = 0.0
    outer_dse_s: float = 0.0
    regions: int = 1
    #: peak bytes held by the compile's indexing layers: the fusion
    #: session's region indexes (``FusionStats.index_peak_bytes``) plus
    #: the final schedule's cached :class:`~repro_torch.core.ir.ScheduleTopology`
    #: (``topology_index_bytes``).  Representation-comparable, not
    #: ``sys.getsizeof``-exact; benchmarks/bench_compile_time reports it
    #: per arm and its ``--compare`` mode gates regressions.
    index_bytes: int = 0
    #: every degradation-ladder rung that fired, in pipeline order —
    #: empty on a clean compile.
    degradations: list[Degradation] = field(default_factory=list)
    #: the exit :class:`~repro_torch.core.verify.VerifyReport` for the returned
    #: plan (post-repair; ``ok`` unless even the ladder's bottom rung
    #: could not produce a legal plan, e.g. a genuinely cyclic graph).
    verify: VerifyReport | None = None
    #: the exit :class:`~repro_torch.core.analyze.AnalyzeReport` — static
    #: dataflow hazard findings (deadlock / shard-race / ordering /
    #: invariant families) for the *returned* schedule, whichever
    #: degradation rung produced it.  Clean compiles report zero
    #: findings; a rolled-back balance pass, for example, legitimately
    #: surfaces the reconvergent hazards it left behind.
    analyze: AnalyzeReport | None = None
    meta: dict = field(default_factory=dict)

    @property
    def pre_dse_s(self) -> float:
        """Total pre-DSE structural-pass wall time."""
        return (self.construct_s + self.fuse_s + self.lower_s + self.mp_s
                + self.balance_s)

    def degraded(self, stage: str | None = None) -> bool:
        return any(d.stage == stage for d in self.degradations) \
            if stage else bool(self.degradations)


def optimize(graph: Graph, mesh: MeshSpec, *,
             ia: bool = True, ca: bool = True, fuse: bool = True,
             max_parallel_factor: int | None = None,
             fsdp: bool = False, training: bool = True,
             beam_width: int = 8, joint_radius: int = 1,
             sweep_workers: int | None = None,
             seed_uniform: bool | None = None,
             budget_s: float | None = None,
             dse_mode: str = "hierarchical",
             warm_start: Snapshot | None = None,
             warm_entries: list[Snapshot] | None = None
             ) -> tuple[Schedule, ShardingPlan, OptimizeReport]:
    """Run the five-step HIDA-OPT pipeline and derive the sharding plan.

    Args:
        graph: Functional dataflow graph (mutated in place by the passes).
        mesh: target mesh axes, e.g. ``SINGLE_POD`` (16×16).
        ia / ca / fuse: paper Fig. 11 ablation switches (intensity-aware
            budgets, connection-aware scoring, task fusion).
        max_parallel_factor: global parallel-factor budget (defaults to
            the chip count).
        fsdp: emit FSDP-style weight sharding in the plan.
        training: include weight-gradient sync traffic in the QoR model.
        beam_width: width of the parallelizer's beam search over joint
            multi-node proposals; ``<= 1`` falls back to pure greedy
            coordinate descent (see :func:`repro_torch.core.parallelize`).
        joint_radius: affected-set hops re-optimized around each joint
            move's origin.
        sweep_workers: thread-pool width for graph-colored sweep scoring
            (does not change the plan; ``None``/1 = serial).  Only useful
            on free-threaded Python — under the GIL it slows compiles
            slightly; leave ``None`` otherwise.
        seed_uniform: **deprecated, ignored** when the beam is enabled —
            the beam seeds itself with the uniform-assignment family.
        budget_s: wall-clock compile budget in seconds, measured from
            entry.  The DSE becomes *anytime*: once the budget expires,
            convergence sweeps and beam rounds stop at the next boundary
            and the best-so-far snapshot is returned (recorded as a
            ``dse`` degradation).  The pre-DSE passes and plan
            derivation always run — they are cheap and required for a
            legal result.  ``None`` (default) never interrupts.  In
            hierarchical mode the budget is split adaptively between the
            inner (per-region) and outer (composition) DSE levels.
        dse_mode: ``"hierarchical"`` (default) or ``"flat"`` — see
            :func:`repro_torch.core.parallelize.parallelize`.  The flat beam
            is the differential-testing oracle; both modes share every
            rung of the degradation ladder.
        warm_start: cached whole-schedule assignment snapshot to seed
            the DSE from (plan-cache nearest-neighbour warm start); the
            beam phase is skipped — see
            :func:`repro_torch.core.parallelize.parallelize`.  All degradation
            rungs still apply.
        warm_entries: extra assignment fragments (donor region
            summaries) tried as alternatives on the warm path.

    Returns:
        ``(schedule, plan, report)``: the parallelized Structural
        schedule, the derived :class:`~repro_torch.core.plan.ShardingPlan`, and
        the pass-by-pass :class:`OptimizeReport`.  Never raises for
        failures inside the pipeline: every fallback taken is listed in
        ``report.degradations`` and the plan is verifier-clean whenever
        the schedule admits a legal plan at all (``report.verify``).
    """
    t0 = time.perf_counter()
    deadline = t0 + budget_s if budget_s is not None else None
    report = OptimizeReport()

    def degrade(stage: str, action: str, error: str = "") -> None:
        report.degradations.append(Degradation(stage, action, error))

    # ---- pre-DSE structural passes.  Each runs inside a transactional
    # rewrite session that rolls back on exception, so catching at the
    # boundary resumes on the pass's *input* IR.
    t = time.perf_counter()
    try:
        construct_functional(graph)
    except Exception as e:
        degrade("construct", "rolled back; continuing on the "
                "unconstructed graph", _exc(e))
    report.construct_s = time.perf_counter() - t
    if fuse:
        t = time.perf_counter()
        try:
            report.fusion = fuse_tasks(graph)
        except Exception as e:
            degrade("fuse", "rolled back; continuing unfused", _exc(e))
        report.fuse_s = time.perf_counter() - t
    t = time.perf_counter()
    try:
        sched = lower_to_structural(graph)
    except Exception as e:
        degrade("lower", "fell back to the single-node schedule", _exc(e))
        sched = fallback_schedule(graph)
    report.lower_s = time.perf_counter() - t
    t = time.perf_counter()
    try:
        report.multi_producer = eliminate_multi_producers(sched)
    except Exception as e:
        degrade("mp", "rolled back; multi-producer buffers remain",
                _exc(e))
    report.mp_s = time.perf_counter() - t
    t = time.perf_counter()
    try:
        report.balance = balance_paths(sched)
    except Exception as e:
        degrade("balance", "rolled back; unbalanced paths remain",
                _exc(e))
    report.balance_s = time.perf_counter() - t

    # ---- DSE ladder: beam (anytime under ``deadline``, internally
    # falling back to converged greedy) → uniform-assignment family →
    # all-replicated.
    dse_fell_back = False
    try:
        report.parallelize = parallelize(
            sched, mesh, ia=ia, ca=ca, training=training,
            max_parallel_factor=max_parallel_factor,
            beam_width=beam_width, joint_radius=joint_radius,
            sweep_workers=sweep_workers, deadline=deadline,
            dse_mode=dse_mode,
            warm_start=warm_start, warm_entries=warm_entries,
            # Joint uniform moves are a CA concept: keep the legacy escape
            # hatch suppressed in the CA-off ablation arm, as before.
            seed_uniform=(seed_uniform if ca or seed_uniform is None
                          else False))
        report.inner_dse_s = report.parallelize.inner_dse_s
        report.outer_dse_s = report.parallelize.outer_dse_s
        report.regions = report.parallelize.regions
        for msg in report.parallelize.degraded:
            degrade("dse", "DSE degradation; best pre-failure snapshot "
                    "kept", msg)
        if report.parallelize.budget_expired:
            degrade("dse", "wall-clock budget expired; best-so-far "
                    "snapshot returned")
        # The parallelizer's incremental engine already holds the final QoR
        # (bit-identical to the batch reference — tests/test_incremental.py
        # asserts so); fall back to ``estimate()`` only if it is absent.
        report.cost = (report.parallelize.cost
                       if report.parallelize.cost is not None
                       else estimate(sched, mesh, training=training))
    except Exception as e:
        dse_fell_back = True
        degrade("dse", "DSE failed; applied the best uniform assignment",
                _exc(e))
        try:
            _assign, report.cost = best_uniform(
                sched, mesh, max_parallel_factor=max_parallel_factor,
                ia=ia, training=training,
                regions=_floor_regions(sched))
        except Exception as e2:
            degrade("dse", "uniform fallback failed; cleared all "
                    "assignments (replicated)", _exc(e2))
            for n in sched.nodes:
                n.axis_map, n.unroll = {}, {}
            try:
                report.cost = estimate(sched, mesh, training=training)
            except Exception:
                report.cost = None

    # ---- QoR floor.  Corrupted proposal scores (fault injection) or a
    # budget-interrupted beam can leave an assignment the *true* model
    # rates worse than the uniform family; re-check on the clean batch
    # path and keep the better one.  The floor is **region-aware**
    # (per-region uniform refinement over the same partition the
    # hierarchical DSE searches), so one degraded region cannot drag the
    # composed plan below the whole-schedule floor.  Skipped on clean
    # compiles — the beam already seeds with the uniform family, so the
    # floor holds by construction and the zero-fault path stays
    # bit-identical.
    if not dse_fell_back and (report.degradations
                              or active_injector() is not None):
        saved = {n.name: (dict(n.axis_map), dict(n.unroll))
                 for n in sched.nodes}
        try:
            true_cost = estimate(sched, mesh, training=training)
            _assign, ucost = best_uniform(
                sched, mesh, max_parallel_factor=max_parallel_factor,
                ia=ia, training=training,
                regions=_floor_regions(sched))
            if ucost.total_s < true_cost.total_s:
                report.cost = ucost
                degrade("qor-floor",
                        f"uniform family ({ucost.total_s * 1e3:.3f}ms) "
                        f"beat the degraded DSE result "
                        f"({true_cost.total_s * 1e3:.3f}ms); applied")
            else:
                for n in sched.nodes:
                    n.axis_map, n.unroll = saved[n.name]
                report.cost = true_cost
        except Exception as e:
            for n in sched.nodes:
                if n.name in saved:
                    n.axis_map, n.unroll = saved[n.name]
            degrade("qor-floor", "floor check failed; keeping the DSE "
                    "result", _exc(e))

    # ---- plan derivation ladder: delta-maintained coherent plan → full
    # coherent rebuild → replicated plan.  Runs on the same cached
    # topology the estimator's DSE used (sched.topology()): build_plan
    # projects through it, and the EP widening below re-projects O(Δ)
    # through ShardingPlan.apply_rule_change instead of a full
    # project_rules rebuild.
    t_plan = time.perf_counter()
    plan_coherent = ca
    plan_meta = {"graph": graph.name, "ia": ia, "ca": ca}
    topo = None
    try:
        topo = sched.topology()
        plan = build_plan(sched, mesh, fsdp=fsdp, coherent=ca,
                          meta=dict(plan_meta), topology=topo)

        # Strip per-layer prefixes so models can look up role sites
        # ("qkv", "attn_ctx", "ffn_hidden", …) regardless of block index.
        # Registered as aliases so later delta re-projections keep them
        # fresh.
        for bname in list(plan.buffer_specs):
            if "__" in bname:
                plan.add_role_alias(bname.split("__", 1)[1], bname)
    except Exception as e:
        degrade("plan", "plan derivation failed; replicated-plan "
                "fallback", _exc(e))
        plan = replicated_plan(mesh, fsdp=fsdp)
        plan_coherent = False

    # Capacity-driven EP widening (DeepSeek-scale expert counts): when the
    # expert weights at the chosen EP degree exceed the per-device HBM
    # budget, widen the expert sharding over the data axis — the
    # production EP>TP layout.  Expert weights then live fully sharded by
    # expert and never pass through the FSDP gather path.
    expert_bufs = [b for b in sched.buffers.values()
                   if b.is_weight and "experts" in b.dims]
    if expert_bufs and ca and plan_coherent:
        try:
            repeats = getattr(getattr(graph, "meta", None),
                              "repeat_factor", 1)
            total = sum(b.bytes for b in expert_bufs) * repeats
            n_exp = expert_bufs[0].shape[
                expert_bufs[0].dims.index("experts")]
            cur = tuple(plan.rules.get("experts", ()))
            shard = 1
            for a in cur:
                shard *= mesh.size(a)
            if total / max(shard, 1) > 6e9:
                widened = False
                for a in ("data",):
                    if (a in mesh.names and a not in cur
                            and n_exp % (shard * mesh.size(a)) == 0):
                        cur = cur + (a,)
                        shard *= mesh.size(a)
                        plan.meta["ep_widened"] = list(cur)
                        widened = True
                if not widened and "data" in mesh.names \
                        and n_exp % mesh.size("data") == 0:
                    # Expert count divides data but not data×model (e.g.
                    # deepseek-v2's 160): EP over data + Megatron expert-TP
                    # over model (d_ff column/row split + psum).
                    cur = ("data",)
                    plan.meta["moe_tp"] = "model"
                    plan.meta["ep_widened"] = ["data", "+tp:model"]
                    widened = True
                if widened:
                    try:
                        # Delta re-projection: only the buffer sites whose
                        # access maps reference "experts" (plus their role
                        # aliases) are rewritten — bit-identical to a full
                        # project_rules rebuild (tests/test_plan.py sweeps
                        # every config × shape).
                        plan.apply_rule_change("experts", cur, sched, topo)
                    except Exception as e:
                        degrade("plan", "delta re-projection failed; "
                                "full coherent rebuild", _exc(e))
                        plan.rules["experts"] = tuple(cur)
                        project_rules(plan, sched, topology=topo)
        except Exception as e:
            degrade("plan", "EP widening failed; keeping the unwidened "
                    "plan", _exc(e))
    report.plan_time_s = time.perf_counter() - t_plan

    # ---- exit legality check + repair rungs.  The verifier is
    # independent of everything above; the returned plan must be clean.
    t_verify = time.perf_counter()
    vrep = verify(sched, plan, mesh, coherent=plan_coherent,
                  topology=topo)
    if not vrep.ok:
        degrade("verify", "plan failed verification; full coherent "
                "rebuild",
                "; ".join(sorted({i.code for i in vrep.errors()})))
        try:
            plan = build_plan(sched, mesh, fsdp=fsdp, coherent=True,
                              meta=dict(plan_meta, repaired=True),
                              topology=None)
            for bname in list(plan.buffer_specs):
                if "__" in bname:
                    plan.add_role_alias(bname.split("__", 1)[1], bname)
            plan_coherent = True
            vrep = verify(sched, plan, mesh, coherent=True)
        except Exception as e:
            degrade("verify", "coherent rebuild failed", _exc(e))
    if not vrep.ok:
        degrade("verify", "still illegal after rebuild; cleared node "
                "assignments + replicated plan",
                "; ".join(sorted({i.code for i in vrep.errors()})))
        for n in sched.nodes:
            n.axis_map, n.unroll = {}, {}
        plan = replicated_plan(mesh, fsdp=False)
        plan_coherent = False
        try:
            report.cost = estimate(sched, mesh, training=training)
        except Exception:
            pass
        vrep = verify(sched, plan, mesh, coherent=False)
    report.verify = vrep
    report.verify_s = time.perf_counter() - t_verify

    # ---- exit hazard analysis.  Runs on *every* return path — clean,
    # degraded, fallback_schedule — so no rung of the ladder ships an
    # unchecked dataflow hazard.  analyze() is total (a crashing rule
    # becomes an analyze-internal issue), but the belt-and-braces guard
    # keeps even a broken driver from failing the compile.
    t_analyze = time.perf_counter()
    try:
        report.analyze = analyze(sched, plan, mesh, topology=topo)
        crashed = report.analyze.crashed_rules()
        if crashed:
            degrade("analyze", "analysis rule(s) crashed; hazard report "
                    "incomplete", ", ".join(crashed))
    except Exception as e:
        degrade("analyze", "hazard analysis crashed; no hazard report",
                _exc(e))
    report.analyze_s = time.perf_counter() - t_analyze

    report.compile_time_s = time.perf_counter() - t0
    report.meta = {"nodes": len(sched.nodes),
                   "buffers": len(sched.buffers)}
    # Peak indexing-layer footprint: the fusion session's region indexes
    # plus the schedule's cached topology (edges, owner tables, memos).
    try:
        report.index_bytes = (
            (report.fusion.index_peak_bytes if report.fusion else 0)
            + topology_index_bytes(sched.topology()))
    except Exception:
        report.index_bytes = 0
    return sched, plan, report
