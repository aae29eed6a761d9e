"""Static dataflow hazard analyzer for the ``(Schedule, ShardingPlan)`` IR.

:mod:`repro_torch.core.verify` answers "is this plan a *legal* sharding of this
schedule"; this module answers the orthogonal question HIDA's dataflow
semantics raise: "can this schedule *hang or corrupt data* when it runs"?
A hierarchical dataflow implementation is only sound if every
reconvergent path's skew is absorbed by buffer ``stages`` / FIFO depth
(otherwise the producer stalls and the design artificially deadlocks —
the classic hazard the dataflow-architectural-template and
HLS-transformations literature guard against), if no two sharded
instances write the same buffer region, and if every consumed region has
a single happens-before writer.  ``balance.py`` *inserts* skew chains
and soft FIFOs; nothing before this module ever *proved* they suffice —
degraded-ladder exits, chaos-lane outputs and cache-loaded plans all
shipped unchecked.

Architecture: a **rule registry** in the style of the verifier's check
families, but pluggable — each rule is a named function registered with
:func:`register_rule`, grouped into four hazard families:

* **deadlock** —
  ``deadlock.depth``: recomputes per-edge skew from the cached
  :class:`~repro_torch.core.ir.ScheduleTopology` depth map and proves each
  buffer's ``stages`` absorbs it (``stages >= skew + 1``, the
  ``balance.py`` soft-FIFO contract).  Codes: ``fifo-underdepth`` (an
  external soft FIFO too shallow for its edge's skew),
  ``reconvergent-deadlock`` (an on-chip buffer on a reconvergent
  diamond without the staging to cover the long path), and
  ``token-missing`` (warning: a skewed soft-FIFO edge without its
  elastic ordering token).
  ``deadlock.cycle``: Kahn over the *union* of dataflow and token
  edges — a cycle through a token edge (``token-cycle``) or through
  dataflow alone (``deadlock-cycle``) can never make progress; tokens
  naming unknown nodes are ``token-dangling``.
* **shard-race** —
  ``race.shard``: cross-checks writer access maps (and the plan's
  rules, when given) for write-write overlap: two *writers* whose
  access maps index the same buffer axis by different loop dims put
  their unrolled/sharded instances on overlapping regions
  (``shard-race``), and a read-modify-write node unrolled over a loop
  dim its access map never indexes has every instance clobbering the
  others' updates (``rw-lost-update``).  Reader-side dim aliasing
  (e.g. attention reading a ``seq``-indexed buffer under ``kv_seq``)
  is *not* flagged — under value semantics a disagreeing read is a
  legal resharding, which is why the detector is writer-only.
* **ordering** —
  ``order.writers``: every pair of writers of a shared buffer must be
  ordered by happens-before (dataflow ∪ token edges), else the
  consumed region has no single last writer (``write-order``) — the
  invariant multi-producer elimination exists to establish.
  ``order.alias``: ``add_role_alias`` bookkeeping — an alias whose
  source is itself an alias goes stale under the one-hop
  ``apply_rule_change`` refresh (``alias-chain``), a source without a
  spec is dangling (``alias-missing``), and an alias spec that no
  longer mirrors its source is stale (``alias-drift``).  Runs from a
  plan alone (``plan_only``), so the plan cache can gate loads on it.
* **invariant** —
  ``invariant.index``: cheap session-invariant lint — the maintained
  :class:`ScheduleTopology` must match a from-scratch rebuild
  (``topology-stale``; capped at :data:`DEEP_CHECK_NODE_CAP` nodes,
  the skip is recorded in ``stats``), its memoized topo order / depth
  map must match re-derivation (``order-stale`` / ``depth-stale``),
  and the schedule's name→node cache must agree with the node list
  (``node-cache-stale``).  The from-scratch sweeps the selfcheck mode
  of the rewrite sessions runs under tests, runnable on any schedule.

Every rule runs inside its own guard with a ``fault_point
("analyze.rules")`` injection site: a crashing rule becomes an
``analyze-internal`` issue on the report (and a recorded
``Degradation`` in ``optimize()``), never an exception — the analyzer
shares the verifier's never-take-the-pipeline-down contract.  It is
read-only and draws no fresh names, so the zero-fault compile path
stays bit-identical with or without it.

Where it runs: on every :func:`repro_torch.core.optimize.optimize` exit
(every degradation-ladder rung included — ``report.analyze`` /
``report.analyze_s``), on :meth:`repro_torch.core.plan_cache.PlanCache.fetch`
before a cached plan is reused (plan-only rules, via
:func:`analyze_plan`), as a serving pre-flight in
``repro_torch.launch.serve`` (the reference's CI CLI, ``python -m
repro.lint``, is not ported).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .estimator import MeshSpec
from .faults import fault_point
from .ir import (MemoryEffect, Schedule, ScheduleTopology, depth_map_over,
                 topo_order_over)
from .plan import ShardingPlan

__all__ = ["AnalysisIssue", "AnalysisRule", "AnalyzeReport", "analyze",
           "analyze_plan", "register_rule", "registered_rules",
           "DEEP_CHECK_NODE_CAP"]

#: node-count ceiling for the invariant family's from-scratch topology
#: rebuild (O(nodes × args) — ~150 ms at 5k nodes, far over the lint's
#: per-compile budget).  Above it the deep compare is skipped and the
#: skip recorded in ``report.stats["invariant_deep_skipped"]`` — never a
#: silent cap.  The memo checks (order/depth) stay on at every size.
DEEP_CHECK_NODE_CAP = 3000


@dataclass(frozen=True)
class AnalysisIssue:
    code: str       # machine-readable hazard identifier (see module doc)
    severity: str   # "error" | "warning"
    site: str       # node / buffer / token / alias name ("" = global)
    message: str

    def __str__(self) -> str:  # pragma: no cover - repr convenience
        return f"[{self.severity}:{self.code}] {self.site}: {self.message}"


@dataclass
class AnalyzeReport:
    issues: list[AnalysisIssue] = field(default_factory=list)
    #: individual hazard predicates evaluated (an empty schedule
    #: trivially passes — assert on this to know the rules did work).
    checks: int = 0
    #: rules that ran to completion (crashed rules are absent here and
    #: present as ``analyze-internal`` issues instead).
    rules_run: list[str] = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.errors()

    def errors(self) -> list[AnalysisIssue]:
        return [i for i in self.issues if i.severity == "error"]

    def warnings(self) -> list[AnalysisIssue]:
        return [i for i in self.issues if i.severity == "warning"]

    def codes(self) -> set[str]:
        return {i.code for i in self.issues}

    def crashed_rules(self) -> list[str]:
        """Rules whose guard caught an exception (``analyze-internal``)."""
        return sorted({i.site for i in self.issues
                       if i.code == "analyze-internal"})

    def summary(self) -> str:
        errs, warns = self.errors(), self.warnings()
        if not errs and not warns:
            return (f"analyze: clean ({self.checks} checks, "
                    f"{len(self.rules_run)} rules)")
        head = (f"analyze: {len(errs)} hazard(s), {len(warns)} warning(s) "
                f"over {self.checks} checks")
        lines = [str(i) for i in errs[:8]] + \
            ([f"... {len(errs) - 8} more"] if len(errs) > 8 else []) + \
            [str(i) for i in warns[:4]]
        return "\n".join([head] + lines)


# --------------------------------------------------------------------------
# Rule registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AnalysisRule:
    name: str           # dotted id, e.g. "deadlock.depth"
    family: str         # deadlock | shard-race | ordering | invariant
    plan_only: bool     # runnable from (plan, mesh) alone — cache gate
    fn: Callable[["_Context"], None]


_RULES: dict[str, AnalysisRule] = {}


def register_rule(name: str, *, family: str, plan_only: bool = False):
    """Register an analysis rule.  Rules run in registration order;
    each receives the :class:`_Context` and reports through
    ``ctx.issue`` — returning findings by raising is a crash, not a
    report.  Third-party / test rules may register too; ``analyze``'s
    ``rules=`` argument selects a subset by name."""
    def deco(fn):
        if name in _RULES:
            raise ValueError(f"analysis rule {name!r} already registered")
        _RULES[name] = AnalysisRule(name, family, plan_only, fn)
        return fn
    return deco


def registered_rules() -> tuple[str, ...]:
    """Registered rule names, in run order."""
    return tuple(_RULES)


@dataclass
class _Context:
    """What a rule sees.  ``sched``/``topo`` are ``None`` for plan-only
    invocations (:func:`analyze_plan`); ``plan``/``mesh`` are ``None``
    when a bare schedule is analyzed."""
    sched: Optional[Schedule]
    plan: Optional[ShardingPlan]
    mesh: Optional[MeshSpec]
    topo: Optional[ScheduleTopology]
    rep: AnalyzeReport

    def issue(self, code: str, site: str, message: str,
              severity: str = "error") -> None:
        self.rep.issues.append(AnalysisIssue(code, severity, site, message))

    def check(self, n: int = 1) -> None:
        self.rep.checks += n


# --------------------------------------------------------------------------
# Family 1: deadlock / FIFO-depth sufficiency
# --------------------------------------------------------------------------

@register_rule("deadlock.depth", family="deadlock")
def _rule_deadlock_depth(ctx: _Context) -> None:
    """stages >= skew + 1 on every positive-skew edge (Fig. 8 contract)."""
    sched, topo = ctx.sched, ctx.topo
    if sched is None or topo is None:
        return
    try:
        depth = topo.depth_of(sched.nodes, sched.name)
    except ValueError:
        return  # cyclic — deadlock.cycle owns that report
    tokens = {(t.src, t.dst) for t in sched.tokens}
    for src, dst, bname in topo.edges:
        skew = depth[dst] - depth[src] - 1
        if skew <= 0:
            continue
        ctx.check()
        buf = sched.buffers.get(bname)
        if buf is None:
            continue
        need = skew + 1
        if buf.stages < need:
            if buf.placement == "external":
                ctx.issue(
                    "fifo-underdepth", bname,
                    f"soft FIFO has stages={buf.stages} but edge "
                    f"{src}->{dst} skips {skew} pipeline level(s) — "
                    f"needs stages >= {need} to absorb the skew "
                    f"(balance.py soft-FIFO contract)")
            else:
                ctx.issue(
                    "reconvergent-deadlock", bname,
                    f"reconvergent path {src}->{dst} skips {skew} "
                    f"pipeline level(s) but the buffer holds only "
                    f"{buf.stages} stage(s): the producer stalls after "
                    f"{buf.stages} frame(s) while the long path still "
                    f"needs {need} in flight — artificial deadlock")
        elif buf.placement == "external" and (src, dst) not in tokens:
            ctx.issue(
                "token-missing", bname,
                f"skewed soft-FIFO edge {src}->{dst} (skew {skew}) has "
                "no TokenEdge ordering the rotation — elastic execution "
                "can reorder producer/consumer iterations",
                severity="warning")


@register_rule("deadlock.cycle", family="deadlock")
def _rule_deadlock_cycle(ctx: _Context) -> None:
    """No cycle through the dataflow ∪ token happens-before relation."""
    sched, topo = ctx.sched, ctx.topo
    if sched is None or topo is None:
        return
    names = {n.name for n in sched.nodes}
    union: list[tuple[str, str]] = [(s, d) for s, d, _ in topo.edges]
    for t in sched.tokens:
        ctx.check()
        missing = [x for x in (t.src, t.dst) if x not in names]
        if missing:
            ctx.issue("token-dangling", f"{t.src}->{t.dst}",
                      f"token edge names unknown node(s) {missing}")
            continue
        union.append((t.src, t.dst))
    ctx.check()
    succ: dict[str, set[str]] = {n: set() for n in names}
    indeg: dict[str, int] = {n: 0 for n in names}
    for s, d in union:
        if d not in succ[s]:
            succ[s].add(d)
            indeg[d] += 1
    ready = [n for n in names if indeg[n] == 0]
    emitted = 0
    while ready:
        n = ready.pop()
        emitted += 1
        for m in succ[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(m)
    if emitted == len(names):
        return
    leftover = {n for n in names if indeg[n] > 0}
    token_in_cycle = any(t.src in leftover and t.dst in leftover
                         for t in sched.tokens)
    sample = ", ".join(sorted(leftover)[:6])
    tail = "..." if len(leftover) > 6 else ""
    ctx.issue(
        "token-cycle" if token_in_cycle else "deadlock-cycle", sched.name,
        f"{len(leftover)} node(s) sit on a happens-before cycle "
        f"({'through a token edge' if token_in_cycle else 'dataflow only'})"
        f": {sample}{tail} — no iteration of these nodes can ever start")


# --------------------------------------------------------------------------
# Family 2: shard-race detection
# --------------------------------------------------------------------------

@register_rule("race.shard", family="shard-race")
def _rule_race_shard(ctx: _Context) -> None:
    """Write-write overlap across unrolled/sharded node instances."""
    sched, topo, plan = ctx.sched, ctx.topo, ctx.plan
    if sched is None or topo is None:
        return
    # Writer-side dim disagreement per buffer axis: instance i of writer
    # A owns the slice dim_A == i while instance i of writer B owns
    # dim_B == i — different dims means the slices overlap.  Readers are
    # exempt: a disagreeing *read* is a legal resharding/gather under
    # value semantics (attention reads seq-produced buffers under
    # kv_seq on half the zoo).
    for bname, per_axis in topo.axis_owner_dims.items():
        writers = {n.name for n in topo.producers.get(bname, ())}
        if len(writers) < 2:
            continue
        for axis, pairs in enumerate(per_axis):
            ctx.check()
            wdims: dict[str, str] = {}
            for node, dim in pairs:
                if node.name in writers:
                    wdims.setdefault(dim, node.name)
            if len(wdims) > 1:
                rules = ""
                if plan is not None:
                    rules = "; rules map " + ", ".join(
                        f"{d!r}->{tuple(plan.rules.get(d, ()))}"
                        for d in sorted(wdims))
                ctx.issue(
                    "shard-race", bname,
                    f"axis {axis} is written under disagreeing loop dims "
                    f"{sorted(wdims)} by {sorted(wdims.values())} — "
                    f"sharded/unrolled writer instances touch "
                    f"overlapping regions{rules}")
    # Lost update: a read-modify-write node unrolled over a dim its
    # access map never indexes runs every instance against the whole
    # region — each read-modify-write clobbers the others.  (A pure
    # writer in the same position is a reduction, handled by psum.)
    for node in sched.nodes:
        for value, eff in node.args.items():
            if eff != MemoryEffect.READ_WRITE:
                continue
            ctx.check()
            am = topo.access_for(node, value)
            if am is None:
                continue
            named = {e[0] for e in am.entries if e[0] is not None}
            for dim, f in node.unroll.items():
                if f and f > 1 and dim not in named:
                    ctx.issue(
                        "rw-lost-update", node.name,
                        f"read-modify-write of {value!r} unrolled x{f} "
                        f"over dim {dim!r}, which its access map never "
                        "indexes — concurrent instances overwrite each "
                        "other's updates")


# --------------------------------------------------------------------------
# Family 3: stale-alias / multi-producer ordering
# --------------------------------------------------------------------------

def _reaches(succ: dict[str, list[str]], src: str, dst: str) -> bool:
    seen = {src}
    stack = [src]
    while stack:
        for m in succ.get(stack.pop(), ()):
            if m == dst:
                return True
            if m not in seen:
                seen.add(m)
                stack.append(m)
    return False


@register_rule("order.writers", family="ordering")
def _rule_order_writers(ctx: _Context) -> None:
    """Each shared buffer's writers are totally happens-before ordered."""
    sched, topo = ctx.sched, ctx.topo
    if sched is None or topo is None:
        return
    multi = {b: ps for b, ps in topo.producers.items() if len(ps) > 1}
    if not multi:
        return
    succ: dict[str, list[str]] = {}
    for s, d, _ in sched.happens_before_edges():
        succ.setdefault(s, []).append(d)
    for bname, prods in sorted(multi.items()):
        names = [p.name for p in prods]
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                ctx.check()
                a, b = names[i], names[j]
                if not (_reaches(succ, a, b) or _reaches(succ, b, a)):
                    ctx.issue(
                        "write-order", bname,
                        f"writers {a!r} and {b!r} are unordered by "
                        "happens-before (no dataflow or token path "
                        "either way) — the consumed region has no "
                        "single last writer")


@register_rule("order.alias", family="ordering", plan_only=True)
def _rule_order_alias(ctx: _Context) -> None:
    """add_role_alias chains stay single-hop, fresh and resolvable."""
    plan = ctx.plan
    if plan is None:
        return
    for role, source in plan.role_sources.items():
        ctx.check()
        if source in plan.role_sources:
            ctx.issue(
                "alias-chain", role,
                f"alias source {source!r} is itself an alias of "
                f"{plan.role_sources[source]!r} — apply_rule_change "
                "re-projects one hop, so chained aliases go stale on "
                "the next rule change")
        if source not in plan.buffer_specs:
            ctx.issue("alias-missing", role,
                      f"alias source {source!r} has no stored spec")
        elif plan.buffer_specs.get(role) != plan.buffer_specs[source]:
            ctx.issue(
                "alias-drift", role,
                f"alias spec {plan.buffer_specs.get(role)} no longer "
                f"mirrors source {source!r} spec "
                f"{plan.buffer_specs[source]} — stale alias")


# --------------------------------------------------------------------------
# Family 4: session-invariant lint
# --------------------------------------------------------------------------

def _same_owner_lists(a: dict, b: dict) -> bool:
    """Name-compare two {buffer: [Node, ...]} maps without materialising
    fingerprint dicts (the rewrite-session selfcheck's
    ``schedule_topology_fingerprint`` builds full name dumps — fine for
    tests, ~3x the rebuild cost here)."""
    ka = {k for k, v in a.items() if v}
    if ka != {k for k, v in b.items() if v}:
        return False
    for k in ka:
        va, vb = a[k], b[k]
        if len(va) != len(vb):
            return False
        for x, y in zip(va, vb):
            if x.name != y.name:
                return False
    return True


def _topology_matches(cached: ScheduleTopology,
                      fresh: ScheduleTopology) -> bool:
    """Semantic equality of two topologies (lazy ``_access`` and memo
    caches excluded), early-exit piecewise."""
    if cached.edges != fresh.edges:
        return False
    if cached.axis_dims != fresh.axis_dims:
        return False
    if cached.buffers_of_dim != fresh.buffers_of_dim:
        return False
    if not _same_owner_lists(cached.producers, fresh.producers):
        return False
    if not _same_owner_lists(cached.consumers, fresh.consumers):
        return False
    if cached.axis_owner_dims.keys() != fresh.axis_owner_dims.keys():
        return False
    for bname, per_axis in cached.axis_owner_dims.items():
        other = fresh.axis_owner_dims[bname]
        if len(per_axis) != len(other):
            return False
        for pa, pb in zip(per_axis, other):
            if len(pa) != len(pb):
                return False
            for (na, da), (nb, db) in zip(pa, pb):
                if da != db or na.name != nb.name:
                    return False
    return True


@register_rule("invariant.index", family="invariant")
def _rule_invariant_index(ctx: _Context) -> None:
    """Maintained topology / memos / node cache match from-scratch."""
    sched = ctx.sched
    if sched is None:
        return
    cached = sched._topology
    if cached is not None \
            and cached.signature == sched.structure_signature():
        # A cached topology whose signature mismatches is merely lazy
        # (topology() rebuilds it) — the hazard is a *matching*
        # signature over stale content: a maintenance bug every
        # downstream consumer (DSE, plan projection, this analyzer)
        # would silently trust.
        if len(sched.nodes) <= DEEP_CHECK_NODE_CAP:
            ctx.check()
            fresh = ScheduleTopology.build(sched)
            if not _topology_matches(cached, fresh):
                ctx.issue(
                    "topology-stale", sched.name,
                    "maintained ScheduleTopology no longer matches a "
                    "from-scratch rebuild despite a matching structure "
                    "signature — index maintenance bug")
        else:
            ctx.rep.stats["invariant_deep_skipped"] = len(sched.nodes)
        try:
            if cached._order_memo is not None:
                ctx.check()
                want = [n.name for n in topo_order_over(
                    sched.nodes, cached.edges, sched.name)]
                if [n.name for n in cached._order_memo] != want:
                    ctx.issue("order-stale", sched.name,
                              "memoized topo order differs from "
                              "re-derivation over the same edges")
            if cached._depth_memo is not None:
                ctx.check()
                want_d = depth_map_over(sched.nodes, cached.edges,
                                        sched.name)
                if cached._depth_memo != want_d:
                    ctx.issue("depth-stale", sched.name,
                              "memoized depth map differs from "
                              "re-derivation over the same edges")
        except ValueError:
            pass  # cyclic — deadlock.cycle owns that report
    cache = sched._node_cache
    if cache is not None and sched._node_cache_len == len(sched.nodes):
        ctx.check()
        live = {n.name: n for n in sched.nodes}
        if set(cache) != set(live) or any(
                live.get(k) is not v for k, v in cache.items()):
            ctx.issue("node-cache-stale", sched.name,
                      "name->node cache disagrees with the node list "
                      "(missed rename or in-place replacement)")


# --------------------------------------------------------------------------
# Drivers
# --------------------------------------------------------------------------

def analyze(sched: Optional[Schedule], plan: ShardingPlan | None = None,
            mesh: MeshSpec | None = None, *,
            topology: ScheduleTopology | None = None,
            rules: Sequence[str] | None = None) -> AnalyzeReport:
    """Run the registered hazard rules over ``(sched, plan, mesh)``.

    Read-only and total: a crashing rule (organic or injected via the
    ``analyze.rules`` fault site) becomes an ``analyze-internal`` issue,
    never an exception.  ``sched=None`` runs only the ``plan_only``
    rules (what :func:`analyze_plan` does); ``rules=`` selects a subset
    by registered name.

    Args:
        sched: the Structural schedule, or ``None`` for plan-only lint.
        plan: sharding plan (enables plan-aware context in shard-race
            messages and the alias rules).
        mesh: target mesh (context for rules that want axis sizes).
        topology: shared :class:`ScheduleTopology`; defaults to the
            schedule's cached one.
        rules: rule-name subset (default: all registered).
    """
    t0 = time.perf_counter()
    rep = AnalyzeReport()
    if rules is None:
        selected = list(_RULES.values())
    else:
        unknown = [r for r in rules if r not in _RULES]
        if unknown:
            raise ValueError(f"unknown analysis rule(s) {unknown}; "
                             f"registered: {sorted(_RULES)}")
        selected = [_RULES[r] for r in rules]

    topo = topology
    if sched is not None and topo is None:
        try:
            topo = sched.topology()
        except Exception as e:
            rep.issues.append(AnalysisIssue(
                "analyze-internal", "error", "topology",
                f"topology construction failed: {type(e).__name__}: {e}"))
    ctx = _Context(sched=sched, plan=plan, mesh=mesh, topo=topo, rep=rep)

    skipped = 0
    for rule in selected:
        if sched is None and not rule.plan_only:
            skipped += 1
            continue
        try:
            fault_point("analyze.rules")
            rule.fn(ctx)
            rep.rules_run.append(rule.name)
        except Exception as e:  # never take the pipeline down
            rep.issues.append(AnalysisIssue(
                "analyze-internal", "error", rule.name,
                f"rule crashed: {type(e).__name__}: {e}"))
    if skipped:
        rep.stats["rules_skipped_no_schedule"] = skipped
    if sched is not None:
        rep.stats.setdefault("nodes", len(sched.nodes))
        rep.stats.setdefault("buffers", len(sched.buffers))
    rep.elapsed_s = time.perf_counter() - t0
    return rep


def analyze_plan(plan: ShardingPlan, mesh: MeshSpec) -> AnalyzeReport:
    """Schedule-free hazard lint of a plan — the plan-cache *reuse*
    gate, complementing :func:`repro_torch.core.verify.verify_static`.  Runs
    only the ``plan_only`` rules (today: the alias-ordering family;
    ``role_sources`` is not serialized, so disk-tier entries trivially
    pass — the gate defends the memory tier, where plans are mutated in
    place by ``apply_rule_change``).  Microsecond-cheap; same
    never-crash contract as :func:`analyze`."""
    return analyze(None, plan, mesh,
                   rules=[n for n, r in _RULES.items() if r.plan_only])
