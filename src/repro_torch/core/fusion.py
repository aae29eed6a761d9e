"""Functional dataflow task fusion — paper Algorithm 2.

Two phases per ``dispatch`` region, processed top-down (pre-order):

1. *Pattern-driven worklist fusion*: pre-defined profitable fusion patterns
   (e.g. matmul + element-wise epilogue, norm into the next matmul,
   element-wise chains) are applied until no pattern matches.

2. *Least-critical re-balancing*: repeatedly fuse the two least-critical
   adjacent tasks while the fusion does not create a new critical task —
   i.e. while ``intensity(t0)+intensity(t1) <= max_task_intensity``.  This
   balances the dataflow (the critical task bounds pipeline throughput).

Finally the dispatch/task hierarchy is canonicalised (a task owning a
single sub-task collapses, empty dispatches disappear).

Every structural mutation flows through
:class:`~repro_torch.core.rewrite.GraphRewriteSession`: adjacency / cycle
queries are lookups against the session's per-dispatch region index
(direct edges + an incrementally-maintained reachability closure — no
DFS per query), pattern matching reads the shared
:class:`~repro_torch.core.ir.GraphTopology` leaf-kind rollups, the balance
phase runs a Δ-maintained candidate-pair heap (seeded once from the
region's edges, extended only with pairs incident to the last fusion —
the former per-step all-pairs re-enumeration with a DFS per pair was the
dominant pre-DSE compile cost), and the final hierarchy canonicalisation
is a single transactional
:meth:`~repro_torch.core.rewrite.GraphRewriteSession.canonicalize`.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field

from .faults import fault_point
from .ir import Graph, Op, make_task
from .rewrite import GraphRewriteSession


# --------------------------------------------------------------------------
# Fusion patterns
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FusionPattern:
    """Profitable producer→consumer fusion pattern.

    Matches when a task whose *last* leaf op has kind ``producer`` feeds a
    task whose leaf ops all have kinds in ``consumer`` (epilogue-style
    fusion).  ``name`` is for logging only.
    """

    name: str
    producer: str
    consumer: frozenset[str]

    def matches(self, p: Op, c: Op) -> bool:
        p_leaves = [o for o in p.walk() if not o.has_region]
        c_leaves = [o for o in c.walk() if not o.has_region]
        if not p_leaves or not c_leaves:
            return False
        return (p_leaves[-1].kind == self.producer
                and all(o.kind in self.consumer for o in c_leaves))

    def matches_meta(self, p_meta: tuple, c_meta: tuple) -> bool:
        """:meth:`matches` over memoized ``GraphTopology.leaf_meta``
        rollups ``(last leaf kind, frozenset of leaf kinds)`` — no region
        re-walk per candidate pair."""
        return (bool(c_meta[1]) and p_meta[0] == self.producer
                and c_meta[1] <= self.consumer)


def default_patterns() -> list[FusionPattern]:
    """Patterns mirroring the paper's "profitable fusion patterns" plus the
    DNN-compiler classics (element-wise epilogues, norm folding)."""
    ew = frozenset({"elementwise", "activation", "bias", "residual",
                    "scale", "mask", "cast"})
    return [
        FusionPattern("ew-chain", "elementwise", ew),
        FusionPattern("matmul-epilogue", "matmul", ew),
        FusionPattern("conv-epilogue", "conv", ew),
        FusionPattern("scan-epilogue", "scan", ew),
        FusionPattern("attn-epilogue", "attention", ew),
        FusionPattern("norm-into-matmul", "norm", frozenset({"matmul"})),
        FusionPattern("router-dispatch", "router",
                      frozenset({"moe_dispatch"})),
        FusionPattern("gate-combine", "moe_combine", ew),
    ]


# --------------------------------------------------------------------------
# Connectivity helpers (transparent regions: values flow by name)
# --------------------------------------------------------------------------

def _produces(t: Op) -> set[str]:
    return set(t.all_outs())


def _consumes(t: Op) -> set[str]:
    return set(t.all_ins())


def adjacent(a: Op, b: Op) -> bool:
    """True when a feeds b or b feeds a through any value (standalone
    form; the fusion phases use the session's maintained region index)."""
    return bool(_produces(a) & _consumes(b)) or bool(_produces(b) & _consumes(a))


# --------------------------------------------------------------------------
# Algorithm 2
# --------------------------------------------------------------------------

@dataclass
class FusionStats:
    pattern_fusions: int = 0
    balance_fusions: int = 0
    #: peak bytes held by the rewrite session's region indexes (closure
    #: rows, rank maps, consumer buckets) over the whole fusion run —
    #: sampled at every structural commit point, reported per arm by
    #: ``bench_compile_time`` and gated by its memory comparison.
    index_peak_bytes: int = 0
    log: list[str] = field(default_factory=list)


def _pattern_phase(d: Op, patterns: list[FusionPattern],
                   stats: FusionStats, rs: GraphRewriteSession) -> None:
    worklist = deque(d.region)
    while worklist:
        t = worklist.popleft()
        if not rs.alive(d, t):
            continue    # already fused away
        # Candidates must be adjacent, so scanning t's neighbours (in
        # region order — the order a full `d.region` scan would visit)
        # is equivalent to the old O(region) sweep per worklist item.
        for u in rs.neighbors_in_order(d, t):
            if rs.creates_cycle(d, t, u):
                continue
            p, c = rs.order(d, t, u)
            pm, cm = rs.leaf_meta(p), rs.leaf_meta(c)
            if any(pat.matches_meta(pm, cm) for pat in patterns):
                fault_point("fusion.pattern")
                merged = rs.fuse(d, p, c)
                stats.pattern_fusions += 1
                stats.log.append(f"pattern: {p.name}+{c.name}->{merged.name}")
                worklist.append(merged)
                break


#: tasks below this fraction of the critical intensity are "light" — the
#: re-balancing phase only absorbs light tasks into neighbours.  Fusing two
#: heavy tasks with different parallel dims would collapse the
#: parallelization granularity (one unroll set per node), which on TPU
#: means replicating one of the two matmul families — never profitable.
LIGHT_FRACTION = 0.05


def _balance_phase(d: Op, stats: FusionStats, rs: GraphRewriteSession,
                   max_tasks: int | None = None) -> None:
    """Least-critical re-balancing over a Δ-maintained candidate heap.

    Candidate pairs are seeded once from the region's edge set and
    extended only with pairs incident to each fusion's merged task; the
    heap key is ``(combined intensity, rank(a), rank(b))`` with the
    session's program-order ranks as the **explicit tie-break** (the old
    all-pairs ``min()`` resolved ties by enumeration order — the same
    order, but implicitly; ranks are static per task, so entries never
    go stale as the region list shifts).  Lazy invalidation keeps the
    heap honest:

    * entries whose endpoint was fused away are dropped on pop;
    * cycle-creating pairs are dropped *permanently* on pop — fusing
      other pairs only contracts the region graph, which can add paths
      between two live tasks but never remove one.  The exception is the
      session's vanished-edge fallback (a fuse over a multi-produced
      value can sever an edge): it bumps ``region_epoch``, on which the
      heap reseeds from the full edge set so a discarded pair that
      became legal is reconsidered — matching the old per-step
      re-enumeration on such graphs;
    * pairs failing the light-task guard are parked in a side heap keyed
      by min-intensity and promoted when the critical intensity (which
      is non-decreasing) grows enough — or wholesale while ``max_tasks``
      forces fusion past the guard.
    """
    region = d.region
    if len(region) <= 1:
        return
    crit = max(rs.intensity(t) for t in region)
    seq = itertools.count()

    def entry(a: Op, b: Op) -> tuple:
        a, b = rs.order(d, a, b)
        ia, ib = rs.intensity(a), rs.intensity(b)
        # (sum, rank, rank) is unique among *live* pairs (ranks are unique
        # per live task), so the sequence number never influences which
        # candidate is selected — it only keeps comparisons away from the
        # Op payload when a dead entry collides with a live one (e.g. a
        # zero-intensity fusion leaves sum and inherited rank unchanged).
        return (ia + ib, rs.rank(d, a), rs.rank(d, b), next(seq),
                min(ia, ib), a, b)

    active = [entry(a, b) for a, b in rs.adjacent_pairs(d)]
    heapq.heapify(active)
    deferred: list[tuple] = []   # (min_int, sum, rank, rank, seq, a, b)
    epoch = rs.region_epoch(d)

    while len(region) > 1:
        forced = max_tasks is not None and len(region) > max_tasks
        limit = LIGHT_FRACTION * crit
        while deferred and (forced or deferred[0][0] <= limit):
            mn, s, ra, rb, sq, a, b = heapq.heappop(deferred)
            heapq.heappush(active, (s, ra, rb, sq, mn, a, b))
        cand = None
        while active:
            s, ra, rb, sq, mn, a, b = heapq.heappop(active)
            if not (rs.alive(d, a) and rs.alive(d, b)):
                continue
            if not forced and mn > limit:
                heapq.heappush(deferred, (mn, s, ra, rb, sq, a, b))
                continue
            if rs.creates_cycle(d, a, b):
                continue
            cand = (s, a, b)
            break
        if cand is None:
            break
        s, a, b = cand
        # Paper line 9: stop when fusing would create a new critical task.
        if s > crit and not forced:
            break
        fault_point("fusion.balance")
        merged = rs.fuse(d, a, b)
        crit = max(crit, rs.intensity(merged))
        if rs.region_epoch(d) != epoch:
            # Reachability shrank (vanished-edge fallback): permanently-
            # discarded cycle pairs may be legal now — reseed from the
            # live edge set.  Duplicate entries are harmless: identical
            # keys up to seq, and dead copies drop at pop.
            epoch = rs.region_epoch(d)
            for pa, pb in rs.adjacent_pairs(d):
                heapq.heappush(active, entry(pa, pb))
        else:
            for t in rs.neighbors(d, merged):
                heapq.heappush(active, entry(merged, t))
        stats.balance_fusions += 1
        stats.log.append(f"balance: {a.name}+{b.name}->{merged.name}")


def simplify_hierarchy(op: Op) -> Op:
    """Canonicalise dispatch/task nesting (paper Alg. 2 line 10)."""
    op.region = [simplify_hierarchy(c) for c in op.region]
    # task{ task{...} } -> task{...};  dispatch{ task } -> that task's body
    if op.kind in ("task", "dispatch") and len(op.region) == 1:
        child = op.region[0]
        if child.kind in ("task", "dispatch"):
            return child
        if op.kind == "dispatch":
            return make_task([child], name=op.name)
    return op


def fuse_tasks(graph: Graph, patterns: list[FusionPattern] | None = None,
               max_tasks: int | None = None,
               selfcheck: bool = False) -> FusionStats:
    """Paper Algorithm 2 over every dispatch in pre-order (in place).

    Fewer, better-balanced tasks is what keeps the downstream DSE
    tractable: the parallelizer's proposal enumeration and the beam
    search's joint-move neighbourhoods both scale with the node count of
    the lowered schedule, so fusion here is the first half of the
    "hierarchy makes the DSE scale" claim.

    The whole worklist runs inside one
    :class:`~repro_torch.core.rewrite.GraphRewriteSession` — on an exception the
    graph rolls back to its pre-fusion structure, and on success the
    maintained topology is committed so no downstream pass pays a
    re-index.

    Args:
        graph: Functional graph whose dispatch regions get fused.
        patterns: profitable producer→consumer patterns (defaults to
            :func:`default_patterns`).
        max_tasks: when set, the balance phase keeps fusing (ignoring the
            light-task guard) until each dispatch has at most this many
            tasks — the escape valve for pathologically wide frontends.
        selfcheck: assert the session's maintained topology against a
            from-scratch rebuild after every rewrite (tests only).

    Returns:
        :class:`FusionStats` with per-phase fusion counts and a log.
    """
    patterns = patterns if patterns is not None else default_patterns()
    stats = FusionStats()
    with GraphRewriteSession(graph, selfcheck=selfcheck) as rs:
        for op in list(graph.walk(pre=True)):
            if op.kind == "dispatch":
                _pattern_phase(op, patterns, stats, rs)
                _balance_phase(op, stats, rs, max_tasks)
        rs.canonicalize(simplify_hierarchy)
    stats.index_peak_bytes = rs.index_peak_bytes
    return stats
