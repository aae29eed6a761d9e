"""Intensity- and connection-aware dataflow parallelization — paper
Section 6.5 / Algorithm 4, re-targeted from FPGA loop-unroll factors to
TPU mesh-axis sharding factors.

Steps (paper numbering):

1. **Intensity & connection analysis** — per shared buffer, build the
   permutation map (which loop level of the producer aligns with which loop
   level of the consumer) and the scaling map (access-stride ratio).
2. **Node sorting** — descending by connection count, intensity as the
   tie-breaker.
3. **Parallel factor generation** — per-node max parallel factor
   proportional to intensity under the global budget (the chip count).
4. **Node parallelization** — constrained DSE per node: proposals are
   mesh-axis→loop-dim assignments (the TPU quantization of unroll
   factors); a proposal is invalid when (a) any factor is mutually
   indivisible with the constraint projected from an already-parallelized
   connected node through the scaling+permutation maps, or (b) the node's
   total parallelism exceeds its intensity-derived parallel factor.  Valid
   proposals are scored with the roofline QoR estimator; the best one is
   applied.

Ablation switches (``ia``, ``ca``) reproduce the paper's IA-only / CA-only
/ naive arms (Fig. 11).

Beyond the paper's greedy step 4, the DSE is a **beam search over joint
multi-node proposals** (``beam_width``, ``joint_radius``):

* A *beam state* is one whole-schedule assignment, held as an
  ``IncrementalEstimator`` snapshot; switching between sibling states
  re-applies only the differing nodes.
* The beam is seeded with the converged greedy state plus the family of
  *uniform* axis→dim assignments (one coordinated layout applied to every
  node at once) — the joint moves that rescue schedules locked into an
  all-unsharded basin, where every single-node move pays two reshard
  boundaries that exceed its own gain.  This subsumes the former
  ``seed_uniform`` escape hatch.
* Each round expands the best states through *joint moves*: pick an
  origin node (reshard-paying endpoints first, then by roofline latency),
  take its top runner-up proposals from the memoized enumeration, apply
  one, then greedily re-DSE every node within ``joint_radius`` hops of
  the origin in the affected-set graph.  The resulting whole-schedule
  states compete for the ``beam_width`` slots on total QoR.
* The winner gets full coordinate-descent refinement sweeps, and the
  greedy result is kept when nothing beats it — beam QoR is ≥ greedy QoR
  on every schedule *by construction* (``tests/test_beam.py``).

Compile-time engineering (the DSE is the whole ``optimize()`` hot path;
``benchmarks/bench_compile_time.py`` tracks it PR-over-PR, and its
``--compare`` mode fails on >2× regressions):

* Proposals are scored through the **read-only**
  :meth:`~.incremental.IncrementalEstimator.score` — O(deg) per proposal
  with bit-identical totals to the batch estimator, and no undo-log
  traffic on the scan path.
* ``_proposals()`` enumeration (and each proposal's unroll factors and
  canonical-preference penalty) is memoized per node — the pf cap is fixed
  for the whole ``parallelize()`` call, so every later scan reuses the
  sweep-1 enumeration.
* Constraint projection only scans the connections *incident* to the node
  under DSE (hoisted per-node incidence lists) rather than every
  connection in the schedule.
* Coordinate-descent sweeps keep a **dirty set**: a node is only re-DSE'd
  when its DSE inputs may have changed.  Scoring node *n*'s proposals
  varies the latencies of *n* and its direct consumers only, and reads
  the committed state of *n*'s neighbours (constraints, neighbour-axes
  tie-break) and of the *co-producers* feeding a shared consumer (their
  reshard contribution shifts the consumer's ``max()`` roofline term).
  So a change to node *x* dirties ``neighbours(x) ∪ co_producers(x)``,
  and a clean node provably re-selects the same proposal (its search is
  independent of its own current assignment).
* Sweeps are **graph-colored**: the frontier is level-scheduled over the
  affected-set graph so that every node's earlier-ordered conflicting
  neighbours land in earlier levels.  Nodes within one level have
  non-overlapping DSE neighbourhoods, are scored against the same frozen
  committed state (via the pure ``score()`` path — thread-safe, so
  ``sweep_workers`` can fan a level out over a thread pool), and commit
  together.  In exact arithmetic this chooses the same plan as the serial
  in-order sweep: a same-level commit only shifts a later node's
  re-summed totals by a constant, which cannot reorder its proposals.
  The float re-summation makes that a near- rather than bit-level
  guarantee (a sub-ulp tie could in principle round differently across
  the shift); ``tests/test_beam.py`` asserts plan equality empirically on
  every config.
"""
from __future__ import annotations

import itertools
import math
import re
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Optional

from .estimator import EstimateContext, MeshSpec, ScheduleCost, estimate
from .faults import corrupt_value, fault_point
from .incremental import IncrementalEstimator, Snapshot
from .ir import Node, Schedule
from .rewrite import RegionSpec, dse_regions

# Mesh-axis affinity by loop-dim name: which axes a dim may take, in
# preference order.  Batch-like dims soak up the pure-DP axes; everything
# else competes for the model axis (and may spill onto data/pod when the
# batch is too small to fill them, e.g. long_500k decode with batch=1).
_DATA_AXES = ("pod", "data")
_DIM_AXIS_PREF: dict[str, tuple[str, ...]] = {
    # batch never takes the model axis: mixing DP and TP on one dim breeds
    # the resharding chains GSPMD resolves by full rematerialization.
    # And nothing except batch takes the pod axis: TP/EP/SP across the DCN
    # is never right at this scale.
    "batch": ("pod", "data"),
    "seq": ("model", "data"),
    "kv_seq": ("model", "data"),
}
_DEFAULT_PREF = ("model", "data")


def axis_pref(dim: str) -> tuple[str, ...]:
    for key, pref in _DIM_AXIS_PREF.items():
        if dim == key or dim.startswith(key + "_"):
            return pref
    return _DEFAULT_PREF


# --------------------------------------------------------------------------
# Step 1 — connections
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Connection:
    """A producer→consumer link through a shared buffer (paper Table 4)."""

    src: str
    dst: str
    buffer: str
    # Per buffer axis: (src loop dim, src stride, dst loop dim, dst stride).
    axes: tuple[tuple[Optional[str], Fraction, Optional[str], Fraction], ...]

    def project(self, factors: dict[str, int], from_src: bool
                ) -> dict[str, Fraction]:
        """Project ``factors`` of one endpoint onto the other endpoint's
        loop dims: multiply by the scaling map, permute by the permutation
        map (Alg. 4 lines 3-8)."""
        out: dict[str, Fraction] = {}
        for sdim, sstride, ddim, dstride in self.axes:
            if from_src:
                odim, ostride, mdim, mstride = sdim, sstride, ddim, dstride
            else:
                odim, ostride, mdim, mstride = ddim, dstride, sdim, sstride
            if odim is None or mdim is None:
                continue
            f = factors.get(odim)
            if f is None:
                continue
            out[mdim] = Fraction(f) * ostride / mstride
        return out


def analyze_connections(sched: Schedule) -> list[Connection]:
    topo = sched.topology()
    conns: list[Connection] = []
    for src, dst, bname in topo.edges:
        p, c = sched.node(src), sched.node(dst)
        pam = topo.access_for(p, bname)
        cam = topo.access_for(c, bname)
        if pam is None or cam is None:
            continue
        axes = tuple(
            (pam.entries[i][0], pam.entries[i][1],
             cam.entries[i][0], cam.entries[i][1])
            for i in range(len(pam.entries)))
        conns.append(Connection(src, dst, bname, axes))
    return conns


def connection_count(sched: Schedule,
                     conns: list[Connection] | None = None
                     ) -> dict[str, int]:
    if conns is None:
        conns = analyze_connections(sched)
    count: dict[str, int] = {n.name: 0 for n in sched.nodes}
    for c in conns:
        count[c.src] += 1
        count[c.dst] += 1
    return count


# --------------------------------------------------------------------------
# Step 3 — intensity-proportional parallel factors
# --------------------------------------------------------------------------

def parallel_factors(sched: Schedule, max_pf: int, ia: bool
                     ) -> dict[str, int]:
    """pf(node) ∝ intensity, rounded up to a power of two, capped at
    ``max_pf`` (paper Table 5).  Without IA every node gets ``max_pf``.

    The power-of-two rounding is integer bit-length arithmetic: the
    smallest power of two ≥ x equals the smallest power of two ≥ ⌈x⌉, and
    ``1 << (need - 1).bit_length()`` computes the latter exactly — unlike
    ``2 ** ceil(log2(x))``, whose float log could round an exact power of
    two up a full octave."""
    if not ia:
        return {n.name: max_pf for n in sched.nodes}
    peak = max((n.intensity() for n in sched.nodes), default=1) or 1
    out: dict[str, int] = {}
    for n in sched.nodes:
        share = n.intensity() / peak
        need = max(1, math.ceil(share * max_pf))
        out[n.name] = max(1, min(max_pf, 1 << (need - 1).bit_length()))
    return out


# --------------------------------------------------------------------------
# Step 4 — constrained per-node DSE
# --------------------------------------------------------------------------

def _divisible(constraint: Fraction, factor: int) -> bool:
    """Paper Alg. 4 line 15: mutually indivisible → invalid."""
    if constraint <= 0:
        return True
    a = constraint / factor
    b = Fraction(factor) / constraint
    return a.denominator == 1 or b.denominator == 1


def _shardable_dims(node: Node) -> dict[str, int]:
    # Memoized on the node: the body (and so loop_dims / no_shard) is
    # fixed once the node exists, and the DSE asks for this on every
    # proposal — recomputing it was ~15% of a 5k-node compile.  Callers
    # treat the returned dict as read-only.
    cached = node.__dict__.get("_shardable_memo")
    if cached is not None:
        return cached
    dims = node.loop_dims()
    blocked: set[str] = set()
    for o in node.body:
        blocked.update(o.attrs.get("no_shard", ()))
    cached = {d: s for d, s in dims.items() if s > 1 and d not in blocked}
    node.__dict__["_shardable_memo"] = cached
    return cached


def _proposals(node: Node, mesh: MeshSpec, pf_cap: int
               ) -> list[dict[str, tuple[str, ...]]]:
    """Enumerate mesh-axis→dim assignments.  Each axis is assigned to at
    most one loop dim (or left unused); a dim may take several axes.  The
    factor of a dim is the product of its axes' sizes; dim size must be
    divisible by its factor; total parallelism must not exceed ``pf_cap``
    (Alg. 4 line 17)."""
    dims = _shardable_dims(node)
    axes = list(mesh.axes)
    choices_per_axis: list[list[Optional[str]]] = []
    for aname, asize in axes:
        opts: list[Optional[str]] = [None]
        for d, size in dims.items():
            if aname in axis_pref(d):
                opts.append(d)
        choices_per_axis.append(opts)
    out: list[dict[str, tuple[str, ...]]] = []
    for combo in itertools.product(*choices_per_axis):
        assign: dict[str, list[str]] = {}
        for (aname, asize), d in zip(axes, combo):
            if d is not None:
                assign.setdefault(d, []).append(aname)
        total = 1
        ok = True
        for d, alist in assign.items():
            f = 1
            for a in alist:
                f *= mesh.size(a)
            if dims[d] % f != 0:
                ok = False
                break
            # TPU adaptation of the paper's parallel-factor budget: chips
            # are not a consumable resource (unlike DSPs) — pure data
            # parallelism over the batch dim is free, so only
            # communication-bearing dims count against the IA budget.
            if not (d == "batch" or d.startswith("batch_")):
                total *= f
        if not ok or total > pf_cap:
            continue
        out.append({d: tuple(a) for d, a in assign.items()})
    return out


def _apply(node: Node, proposal: dict[str, tuple[str, ...]],
           mesh: MeshSpec) -> None:
    node.axis_map = dict(proposal)
    node.unroll = {
        d: math.prod(mesh.size(a) for a in axes)
        for d, axes in proposal.items()}


def canonical_node_key(index: int, name: str) -> str:
    """Process-independent node identity for cached assignments.

    Raw node names carry a process-global counter (``task_26`` in one
    build is ``task_59`` in the next), so a snapshot keyed by raw names
    never matches a freshly constructed schedule.  The canonical key
    strips the counter and pins the node's position in schedule order —
    stable across processes for the same (config, shape) pipeline, and a
    harmless miss (not a mis-seed) when structures diverge."""
    return f"{re.sub(r'_[0-9]+$', '', name)}@{index}"


def canonical_snapshot(sched: Schedule) -> Snapshot:
    """The schedule's current assignment keyed by
    :func:`canonical_node_key` — the form the plan cache persists and
    :func:`parallelize` accepts as ``warm_start``/``warm_entries``."""
    return {canonical_node_key(i, n.name): (dict(n.axis_map),
                                            dict(n.unroll))
            for i, n in enumerate(sched.nodes)}


def _remap_warm(frag: Snapshot, canon: dict[str, str],
                live: set[str]) -> Snapshot:
    """Translate a cached fragment onto live node names: raw names that
    still exist pass through, canonical keys map via ``canon``, anything
    else is dropped (a miss, covered by the normal per-node DSE)."""
    out: Snapshot = {}
    for k, v in frag.items():
        if k in live:
            out[k] = v
        elif k in canon:
            out[canon[k]] = v
    return out


def _sanitize_warm(node: Node, axis_map: dict[str, tuple[str, ...]],
                   pf_cap: int, mesh: MeshSpec
                   ) -> dict[str, tuple[str, ...]]:
    """Quantize a cached assignment fragment onto ``node`` under the
    *current* mesh and IA budget: drop dims the node cannot shard, axes
    the mesh does not have (or that another dim of this node already
    took), non-divisible factors, and over-budget entries.  The warm-start
    analogue of :func:`_uniform_proposal` — a seed from a different mesh
    or shape bucket degrades to its legal subset instead of poisoning the
    search with an illegal assignment."""
    dims = _shardable_dims(node)
    names = set(mesh.names)
    prop: dict[str, tuple[str, ...]] = {}
    total = 1
    used: set[str] = set()
    for d, axes in axis_map.items():
        if d not in dims:
            continue
        keep = tuple(a for a in axes if a in names and a not in used)
        if len(keep) != len(tuple(axes)):
            # A partially-legal entry changes the factor; re-check below.
            axes = keep
        if not axes:
            continue
        f = math.prod(mesh.size(a) for a in axes)
        if dims[d] % f:
            continue
        if not (d == "batch" or d.startswith("batch_")):
            if total * f > pf_cap:
                continue
            total *= f
        used.update(axes)
        prop[d] = tuple(axes)
    return prop


# --------------------------------------------------------------------------
# Uniform-assignment family (beam seeds + degradation-ladder bottom rung)
# --------------------------------------------------------------------------

def _uniform_proposal(node: Node, assign: dict[str, tuple[str, ...]],
                      pf_cap: int, mesh: MeshSpec
                      ) -> dict[str, tuple[str, ...]]:
    """Quantize one uniform axis→dim layout onto ``node``: keep only the
    dims the node can shard, drop non-divisible factors, and respect the
    node's IA parallel-factor budget (batch-like dims are budget-free,
    matching ``_proposals``)."""
    dims = _shardable_dims(node)
    prop: dict[str, tuple[str, ...]] = {}
    total = 1
    for d, axes in assign.items():
        if d not in dims:
            continue
        f = math.prod(mesh.size(a) for a in axes)
        if dims[d] % f:
            continue
        if not (d == "batch" or d.startswith("batch_")):
            if total * f > pf_cap:
                continue
            total *= f
        prop[d] = axes
    return prop


#: Above this many schedule nodes the uniform family enumerates only the
#: most-covered dims (below it, every dim — bit-identical to the
#: historical behaviour on every real config, all ≤ 43 nodes).
_UNIFORM_SCALE_N = 256

#: Dim cap for the scaled regime.  The family is quadratic in the dim
#: count, and synthetic 5k-node graphs carry a dozen distinct hidden-dim
#: names whose members score near-identically: a dim shardable in 2% of
#: nodes cannot move a 5k-node total.  Coverage-ranked, ties broken by
#: name for determinism.
_UNIFORM_DIM_CAP = 6


def _uniform_assignments(sched: Schedule) -> list[dict[str, tuple[str, ...]]]:
    """The uniform-assignment family: every (data-axis dim, model-axis
    dim) pairing over the schedule's shardable dims — one coordinated
    layout applied to every node at once.  Past ``_UNIFORM_SCALE_N``
    nodes, only the ``_UNIFORM_DIM_CAP`` dims shardable in the most
    nodes enumerate (scale-aware bound; see the constants above)."""
    cover: dict[str, int] = {}
    for n in sched.nodes:
        for d in _shardable_dims(n):
            cover[d] = cover.get(d, 0) + 1
    all_dims = sorted(cover)
    if (len(sched.nodes) > _UNIFORM_SCALE_N
            and len(all_dims) > _UNIFORM_DIM_CAP):
        all_dims = sorted(sorted(
            cover, key=lambda d: (-cover[d], d))[:_UNIFORM_DIM_CAP])
    cands = []
    for d1 in all_dims + [None]:
        for d2 in all_dims + [None]:
            a: dict[str, tuple[str, ...]] = {}
            if d1 and "data" in axis_pref(d1):
                a[d1] = ("data",)
            if d2 and "model" in axis_pref(d2):
                a[d2] = (a.get(d2, ()) + ("model",))
            if a:
                cands.append(a)
    return cands


def best_uniform(sched: Schedule, mesh: MeshSpec, *,
                 max_parallel_factor: int | None = None,
                 ia: bool = True, training: bool = True,
                 regions: "list[RegionSpec] | None" = None
                 ) -> tuple[dict[str, tuple[str, ...]], ScheduleCost]:
    """Apply the best member of the uniform-assignment family (including
    the all-replicated empty assignment) to ``sched`` in place and return
    ``(assignment, cost)``.

    This is the degradation ladder's bottom DSE rung and the QoR floor
    reference: it deliberately bypasses the incremental engine and every
    fault-injection site — plain proposal application plus the batch
    :func:`~repro_torch.core.estimator.estimate` — so it stays serviceable when
    the machinery above it is the thing that failed.

    With ``regions`` (a :func:`~repro_torch.core.rewrite.dse_regions`
    partition), the floor is **region-aware**: after the whole-schedule
    scan, one coordinate-descent pass re-tries the strongest uniform
    layouts *per region* (complement held fixed) and keeps strict
    improvements.  The result can only be ≤ the whole-schedule floor, so
    a single degraded region can no longer drag the composed plan below
    the old floor.  The returned ``assignment`` is still the best
    whole-schedule family member (the in-place state may be a per-region
    mix of family members)."""
    max_pf = max_parallel_factor or mesh.chips
    pf = parallel_factors(sched, max_pf, ia)
    uniforms = [{}] + _uniform_assignments(sched)
    # One topology walk for the whole scan: every family member (and the
    # per-region retries below) only rewrites axis_map/unroll, so the
    # edge/consumer/weight structure behind EstimateContext never moves.
    # Rebuilding it per estimate() call was O(members × edges) — the
    # dominant cost of the floor at 1k+ nodes.
    ctx = EstimateContext(sched)
    best: tuple[ScheduleCost, dict, dict] | None = None
    scored: list[tuple[float, int]] = []
    for ui, assign in enumerate(uniforms):
        for n in sched.nodes:
            _apply(n, _uniform_proposal(n, assign, pf[n.name], mesh), mesh)
        cost = estimate(sched, mesh, training=training, ctx=ctx)
        scored.append((cost.total_s, ui))
        if best is None or cost.total_s < best[0].total_s:
            best = (cost, assign,
                    {n.name: (dict(n.axis_map), dict(n.unroll))
                     for n in sched.nodes})
    cost, assign, state = best
    for n in sched.nodes:
        n.axis_map, n.unroll = state[n.name]

    if regions and len(regions) > 1:
        # Per-region refinement over the few strongest family members
        # (plus the replicated layout) — bounded at regions × 4 batch
        # estimates so the floor stays serviceable as a fallback.
        scored.sort()
        retry = [uniforms[ui] for _s, ui in scored[:3]]
        if uniforms[0] not in retry:
            retry.append(uniforms[0])
        # Each retry costs a whole-schedule estimate, so at scale the
        # regions × retries product must be budgeted or the floor rung
        # takes minutes at 10k nodes.  Refine the largest regions first
        # (most cost mass); every real config's partition fits inside
        # the budget, so this is a no-op below ~64 regions.
        budget = 256
        if len(regions) * len(retry) > budget:
            regions = sorted(regions, key=lambda s: (-len(s.nodes),
                                                     s.index))
            regions = sorted(regions[:max(1, budget // len(retry))],
                             key=lambda s: s.index)
        node_by_name = {n.name: n for n in sched.nodes}
        for spec in regions:
            rnodes = [node_by_name[nm] for nm in spec.nodes
                      if nm in node_by_name]
            if not rnodes:
                continue
            keep = {n.name: (dict(n.axis_map), dict(n.unroll))
                    for n in rnodes}
            for rassign in retry:
                for n in rnodes:
                    _apply(n, _uniform_proposal(n, rassign, pf[n.name],
                                                mesh), mesh)
                c = estimate(sched, mesh, training=training, ctx=ctx)
                if c.total_s < cost.total_s:
                    cost = c
                    keep = {n.name: (dict(n.axis_map), dict(n.unroll))
                            for n in rnodes}
            for n in rnodes:
                n.axis_map, n.unroll = keep[n.name]
    return assign, cost


# --------------------------------------------------------------------------
# Region summaries (the inner→outer interface of the hierarchical DSE)
# --------------------------------------------------------------------------

def _tuplify(x):
    """Recursively convert lists to tuples (JSON round-trip helper)."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def _listify(x):
    """Recursively convert tuples to lists (inverse of :func:`_tuplify`)."""
    if isinstance(x, tuple):
        return [_listify(v) for v in x]
    return x


def _frag_sig(frag: Snapshot) -> tuple:
    """Canonical signature of an assignment fragment (``axis_map`` only —
    ``unroll`` is derived from it under a fixed mesh)."""
    return tuple(sorted(
        (nm, tuple(sorted((d, tuple(axes)) for d, axes in am.items())))
        for nm, (am, _ur) in frag.items()))


def _region_boundary_sig(spec: RegionSpec,
                         conn_by_edge: dict, buffers: dict) -> tuple:
    """Renaming-stable signature of a region's boundary connections:
    per crossing edge, its direction relative to the region, the shared
    buffer's shape/bytes, and the connection's (dim, stride) axis pairs.
    No node or buffer *names* enter the signature, so renaming every node
    in the schedule leaves it bit-identical (``tests/test_hierarchical``
    pins this)."""
    inside = set(spec.nodes)
    sig = []
    for s, d, bname in spec.boundary:
        direction = "in" if d in inside else "out"
        buf = buffers[bname]
        c = conn_by_edge.get((s, d, bname))
        axes = () if c is None else tuple(
            (sd or "", str(ss), dd or "", str(ds))
            for sd, ss, dd, ds in c.axes)
        sig.append((direction, tuple(buf.shape), buf.bytes, axes))
    return tuple(sorted(sig))


@dataclass
class RegionEntry:
    """One candidate assignment for a region, as scored by its inner
    search with the complement of the schedule held at the converged
    greedy state."""

    #: region-restricted assignment fragment (keys = region node names).
    assignment: Snapshot
    #: whole-schedule QoR with this fragment applied (complement greedy).
    total_s: float
    #: incremental QoR delta vs. the all-greedy schedule (≤ 0 is a win).
    delta_s: float
    #: whole-schedule HBM bytes/device with this fragment applied.
    hbm_bytes: int
    #: region-scoped HBM footprint of this fragment.
    region_hbm_bytes: int
    #: "greedy" | "uniform" | "search".
    origin: str

    def key(self) -> tuple[float, int]:
        return (self.total_s, self.hbm_bytes)

    def to_dict(self) -> dict:
        return {
            "assignment": {
                nm: {"axis_map": {d: list(axes)
                                  for d, axes in am.items()},
                     "unroll": dict(ur)}
                for nm, (am, ur) in self.assignment.items()},
            "total_s": self.total_s, "delta_s": self.delta_s,
            "hbm_bytes": self.hbm_bytes,
            "region_hbm_bytes": self.region_hbm_bytes,
            "origin": self.origin}

    @classmethod
    def from_dict(cls, d: dict) -> "RegionEntry":
        return cls(
            assignment={
                nm: ({dim: tuple(axes)
                      for dim, axes in st["axis_map"].items()},
                     {dim: int(f) for dim, f in st["unroll"].items()})
                for nm, st in d["assignment"].items()},
            total_s=d["total_s"], delta_s=d["delta_s"],
            hbm_bytes=d["hbm_bytes"],
            region_hbm_bytes=d["region_hbm_bytes"], origin=d["origin"])


@dataclass
class RegionSummary:
    """What one region's inner search hands the outer composition level:
    its top-k entries (best first, the converged-greedy entry always
    present), the renaming-stable boundary-connection signature, and the
    region's resource footprint.  JSON round-trips exactly through
    :meth:`to_dict` / :meth:`from_dict`."""

    index: int
    nodes: tuple[str, ...]
    entries: list[RegionEntry]
    boundary_sig: tuple
    #: region-scoped HBM footprint at the greedy entry.
    hbm_bytes: int
    #: wall time of this region's inner search.
    inner_s: float = 0.0
    #: non-empty when the inner search failed and the region was pinned
    #: to its greedy/uniform entries (the ``dse.inner`` ladder rung).
    degraded: str = ""

    def greedy_index(self) -> int:
        return next(i for i, e in enumerate(self.entries)
                    if e.origin == "greedy")

    def to_dict(self) -> dict:
        return {"index": self.index, "nodes": list(self.nodes),
                "entries": [e.to_dict() for e in self.entries],
                "boundary_sig": _listify(self.boundary_sig),
                "hbm_bytes": self.hbm_bytes, "inner_s": self.inner_s,
                "degraded": self.degraded}

    @classmethod
    def from_dict(cls, d: dict) -> "RegionSummary":
        return cls(index=d["index"], nodes=tuple(d["nodes"]),
                   entries=[RegionEntry.from_dict(e)
                            for e in d["entries"]],
                   boundary_sig=_tuplify(d["boundary_sig"]),
                   hbm_bytes=d["hbm_bytes"], inner_s=d["inner_s"],
                   degraded=d["degraded"])


@dataclass
class ParallelizeResult:
    order: list[str] = field(default_factory=list)
    pf: dict[str, int] = field(default_factory=dict)
    evaluated: int = 0
    rejected_constraint: int = 0
    rejected_budget: int = 0
    log: list[str] = field(default_factory=list)
    #: final schedule cost from the incremental engine (bit-identical to
    #: ``estimate(sched, mesh, training)`` on the returned assignment).
    cost: ScheduleCost | None = None
    #: ``total_s`` of the converged greedy coordinate descent, before the
    #: beam phase — the invariant ``cost.total_s <= greedy_total_s`` holds
    #: by construction whenever the beam ran.
    greedy_total_s: float = 0.0
    #: whole-schedule states examined by the beam (seeds + joint-move
    #: successors, before dedup/truncation to the beam width).
    beam_states: int = 0
    #: joint (origin + neighbourhood re-DSE) moves expanded.
    joint_moves: int = 0
    #: degradations taken inside the DSE (e.g. a beam-phase failure that
    #: fell back to the converged greedy snapshot); surfaced into
    #: ``OptimizeReport.degradations`` by ``optimize()``.
    degraded: list[str] = field(default_factory=list)
    #: True when the wall-clock ``deadline`` expired and the search
    #: returned its best-so-far snapshot instead of running to fixpoint.
    budget_expired: bool = False
    #: which DSE actually ran: "flat" (the whole-schedule beam, also the
    #: single-region / ablation path), "hierarchical", or "warm" (seeded
    #: from a cached assignment, beam skipped).
    dse_mode: str = "flat"
    #: True when a ``warm_start`` snapshot seeded the search.
    warm: bool = False
    #: nodes of the schedule covered by the (sanitized) warm seed.
    warm_covered: int = 0
    #: number of regions the hierarchical DSE partitioned the schedule
    #: into (1 when the flat beam ran).
    regions: int = 1
    #: per-region inner-search summaries (hierarchical mode only).
    region_summaries: list[RegionSummary] = field(default_factory=list)
    #: wall time of the inner (per-region) level of the hierarchical DSE.
    inner_dse_s: float = 0.0
    #: wall time of the outer (inter-region composition) level.
    outer_dse_s: float = 0.0


def parallelize(sched: Schedule, mesh: MeshSpec, *,
                max_parallel_factor: int | None = None,
                ia: bool = True, ca: bool = True,
                training: bool = True,
                beam_width: int = 8,
                joint_radius: int = 1,
                beam_rounds: int = 3,
                sweep_workers: int | None = None,
                colored_sweeps: bool = True,
                seed_uniform: bool | None = None,
                deadline: float | None = None,
                dse_mode: str = "hierarchical",
                warm_start: Snapshot | None = None,
                warm_entries: list[Snapshot] | None = None
                ) -> ParallelizeResult:
    """Paper Section 6.5 steps 1-4 over a Structural schedule (in place).

    Steps 1-3 follow the paper; step 4 runs the paper's greedy
    most-connected-first pass, converges it by coordinate descent, then —
    when connection-aware scoring is on — improves it with a beam search
    over joint multi-node proposals (see the module docstring for the
    full design).

    Args:
        sched: Structural schedule; node ``unroll`` / ``axis_map`` are
            assigned in place.
        mesh: target mesh (axis names and sizes).
        max_parallel_factor: global parallel-factor budget (defaults to
            the chip count).
        ia: intensity-aware parallel-factor capping (paper Fig. 11 arm).
        ca: connection-aware scoring and constraint projection (paper
            Fig. 11 arm).  The beam phase requires ``ca``; with it off,
            the result is the paper's greedy per-node DSE.
        training: include weight-gradient sync traffic in the QoR.
        beam_width: number of whole-schedule states kept per beam round.
            ``<= 1`` disables the beam phase entirely (pure greedy
            coordinate descent, the pre-beam behaviour).
        joint_radius: how many hops of the affected-set graph are greedily
            re-optimized around a joint move's origin node.  Radius 1
            covers the producer/consumer pairs whose coordinated unroll
            choices single-node moves cannot reach.
        beam_rounds: maximum joint-move expansion rounds (the beam stops
            early as soon as a round fails to improve the best state).
        sweep_workers: when > 1, each graph-color level of a refinement
            sweep is scored on a thread pool (the scoring path is
            read-only and thread-safe).  Does not change the chosen plan.
            Under the CPython GIL the pure-Python scoring cannot actually
            run concurrently, so this is a small net *slowdown* today —
            it exists for free-threaded builds; leave ``None`` otherwise.
        colored_sweeps: level-schedule sweep frontiers over the
            affected-set graph and score each level as a batch (the
            default).  ``False`` forces strictly serial in-order sweeps —
            the reference semantics, same plan in exact arithmetic (see
            the module docstring for the float-tie caveat;
            ``tests/test_beam.py`` asserts equality on every config).
        seed_uniform: **deprecated, ignored** — the beam's seeding with
            the uniform-assignment family subsumes it (kept so existing
            call sites don't break; pass ``beam_width=0`` *and*
            ``seed_uniform=True`` to run the legacy escape hatch).
        deadline: absolute ``time.perf_counter()`` instant after which
            the search becomes *anytime*: convergence sweeps and beam
            rounds stop at the next boundary and the best-so-far
            snapshot is restored (O(1) via the incremental engine).
            The initial greedy pass always completes — a full assignment
            must exist before "best so far" means anything.  ``None``
            (the default) never interrupts.
        dse_mode: ``"hierarchical"`` (default) runs the two-level DSE —
            per-region inner beams (:func:`~repro_torch.core.rewrite.dse_regions`
            partition) composed by an inter-region outer beam over
            :class:`RegionSummary` entries, with the ``deadline`` budget
            split adaptively between the levels.  ``"flat"`` forces the
            whole-schedule beam (the differential-testing oracle —
            ``tests/test_hierarchical.py`` asserts hierarchical QoR ≤
            flat QoR on every config).  Schedules the partitioner leaves
            whole (or the CA-off / ``beam_width<=1`` arms) always take
            the flat path, bit-identically to ``dse_mode="flat"``.
        warm_start: estimator snapshot from a previous compile of a
            *similar* config (nearest plan-cache entry).  Each covered
            node is seeded with its cached assignment — quantized onto
            the current mesh/shapes by :func:`_sanitize_warm` — instead
            of a fresh greedy scan; uncovered nodes run the normal
            per-node DSE.  The seed then converges by coordinate descent
            and the beam phase is **skipped** (replaced by a cheap
            uniform-family floor scan plus the ``warm_entries``
            alternatives), so the warm wall is a fraction of the cold
            wall.  QoR ≥ the *warm greedy* path by the monotonicity of
            ``converge`` — the cache layer above only serves warm results
            that also beat its recorded cold QoR.
        warm_entries: optional extra assignment fragments (e.g. PR 7
            ``RegionEntry`` summaries from the cached plan's regions)
            tried as whole-schedule alternatives after convergence; the
            best strict improvement wins.
    """
    if dse_mode not in ("hierarchical", "flat"):
        raise ValueError(f"unknown dse_mode {dse_mode!r}")
    if seed_uniform is not None:
        warnings.warn(
            "parallelize(seed_uniform=...) is deprecated: the beam search "
            "seeds itself with the uniform-assignment family "
            "(beam_width/joint_radius control it); see "
            "docs/ARCHITECTURE.md.", DeprecationWarning, stacklevel=2)
    res = ParallelizeResult()
    max_pf = max_parallel_factor or mesh.chips
    conns = analyze_connections(sched)
    counts = connection_count(sched, conns)
    res.pf = parallel_factors(sched, max_pf, ia)
    est = IncrementalEstimator(sched, mesh, training=training)

    # Hoisted DSE structure: per-node incident connections (in global conn
    # order), neighbourhood sets for the dirty-set sweeps, and the memoized
    # proposal enumeration (the pf cap is fixed per node for this call, so
    # the enumeration — and each proposal's unroll factors and static
    # preference penalty — is computed exactly once per node).
    incident: dict[str, list[Connection]] = {n.name: [] for n in sched.nodes}
    affected: dict[str, set[str]] = {n.name: set() for n in sched.nodes}
    producers_of: dict[str, set[str]] = {}
    for c in conns:
        incident[c.src].append(c)
        incident[c.dst].append(c)
        affected[c.src].add(c.dst)
        affected[c.dst].add(c.src)
        producers_of.setdefault(c.dst, set()).add(c.src)
    # Co-producers of a shared consumer influence each other's DSE ranking
    # through the consumer's max() roofline term — they must invalidate
    # each other even though no connection links them directly.
    for prods in producers_of.values():
        for p in prods:
            affected[p] |= prods - {p}

    prop_cache: dict[str, list[tuple[dict[str, tuple[str, ...]],
                                     dict[str, int], int]]] = {}

    def proposals_for(node: Node):
        entry = prop_cache.get(node.name)
        if entry is None:
            entry = []
            for proposal in _proposals(node, mesh, res.pf[node.name]):
                unroll = {
                    d: math.prod(mesh.size(a) for a in axes)
                    for d, axes in proposal.items()}
                pref_pen = sum(
                    0 if axes and axes[0] == axis_pref(d)[0] else 1
                    for d, axes in proposal.items())
                entry.append((proposal, unroll, pref_pen))
            prop_cache[node.name] = entry
        return entry

    # Step 2: sort by (connections, intensity) descending.
    ordered = sorted(
        sched.nodes,
        key=lambda n: (counts.get(n.name, 0), n.intensity()), reverse=True)
    res.order = [n.name for n in ordered]
    all_names = {n.name for n in sched.nodes}

    if warm_start is not None:
        canon = {canonical_node_key(i, n.name): n.name
                 for i, n in enumerate(sched.nodes)}
        warm_start = _remap_warm(warm_start, canon, all_names)
        warm_entries = [_remap_warm(f, canon, all_names)
                        for f in (warm_entries or [])] or None

    def rank_node(node: Node, done: set[str], k: int
                  ) -> tuple[list[tuple[tuple, dict, dict]], int, int]:
        """Constrained DSE scan for ``node`` against the *committed*
        estimator state: returns the ``k`` best ``(key, proposal,
        unroll)`` plus (evaluated, rejected) counts.  Pure — scoring goes
        through the read-only ``est.score()``, so concurrent calls for
        nodes with non-overlapping neighbourhoods are safe."""
        constraints: list[dict[str, Fraction]] = []
        neighbor_axes: dict[str, tuple[str, ...]] = {}
        if ca:
            for c in incident[node.name]:
                if c.src == node.name and c.dst in done:
                    other = sched.node(c.dst)
                    proj = c.project(other.unroll, from_src=False)
                elif c.dst == node.name and c.src in done:
                    other = sched.node(c.src)
                    proj = c.project(other.unroll, from_src=True)
                else:
                    continue
                constraints.append(proj)
                # Remember which mesh axes the neighbour used on the mapped
                # dims so the QoR tie-break prefers axis-identical layouts.
                for sdim, _, ddim, _ in c.axes:
                    mine = ddim if c.dst == node.name else sdim
                    theirs = sdim if c.dst == node.name else ddim
                    if mine and theirs and theirs in other.axis_map:
                        neighbor_axes.setdefault(
                            mine, other.axis_map[theirs])

        evaluated = rejected = 0
        scored: list[tuple[tuple, dict, dict]] = []
        for proposal, unroll, pref_penalty in proposals_for(node):
            evaluated += 1
            valid = True
            for constr in constraints:
                for d, cval in constr.items():
                    if not _divisible(cval, unroll.get(d, 1)):
                        valid = False
                        break
                if not valid:
                    break
            if not valid:
                rejected += 1
                continue
            s = est.score(node.name, proposal, unroll)
            if ca:
                neigh_penalty = sum(
                    1 for d, axes in neighbor_axes.items()
                    if proposal.get(d, ()) != axes)
                key = (corrupt_value("dse.score", s.total_s),
                       s.hbm_bytes, neigh_penalty, pref_penalty)
            else:
                # CA off: ignore the coupling cost, exactly the failure
                # mode Fig. 11 demonstrates.
                key = (corrupt_value("dse.score", s.node_compute_s),
                       -s.node_parallel_factor)
            scored.append((key, proposal, unroll))
        # Stable sort: among equal keys the earliest-enumerated proposal
        # wins, matching the strict `<` selection of a linear scan.
        scored.sort(key=lambda t: t[0])
        return scored[:k], evaluated, rejected

    def dse_node(node: Node, done: set[str]) -> bool:
        """One constrained DSE for ``node`` (Alg. 4).  Returns True when
        the assignment changed."""
        fault_point("dse.node")
        top, evaluated, rejected = rank_node(node, done, 1)
        res.evaluated += evaluated
        res.rejected_constraint += rejected
        best, best_unroll = (top[0][1], top[0][2]) if top else ({}, {})
        prev = dict(node.axis_map)
        est.apply(node.name, best, best_unroll)
        return dict(node.axis_map) != prev

    pool = (ThreadPoolExecutor(max_workers=sweep_workers)
            if colored_sweeps and sweep_workers and sweep_workers > 1
            else None)

    def sweep(frontier: list[Node]) -> tuple[list[str], int]:
        """One coordinate-descent sweep over ``frontier`` (in DSE order),
        graph-colored: the frontier is level-scheduled over the
        affected-set graph (every node lands one level after its last
        earlier-ordered conflicting neighbour), each level is scored
        against the frozen committed state — concurrently when a pool is
        configured — and committed as a batch.  Within a level no node is
        in another's affected set, so the selections are independent of
        commit order and the resulting plan matches the serial in-order
        sweep (exact in real arithmetic; see the module docstring for the
        float-tie caveat; asserted on every config by
        ``tests/test_beam.py``).

        Returns ``(changed node names, color count)`` — color count 0 for
        the serial reference mode."""
        if not colored_sweeps:
            return [node.name for node in frontier
                    if dse_node(node, all_names)], 0
        level: dict[str, int] = {}
        for node in frontier:
            lv = 0
            for m in affected[node.name]:
                if m in level:
                    lv = max(lv, level[m] + 1)
            level[node.name] = lv
        classes: list[list[Node]] = [
            [] for _ in range(1 + max(level.values(), default=0))]
        for node in frontier:
            classes[level[node.name]].append(node)

        changed: list[str] = []
        for cls in classes:
            if pool is not None and len(cls) > 1:
                # Data-sized batching: hand each worker a contiguous
                # slice (~2 slices per worker for tail balance) instead
                # of one node per pool task.  At 1k+ nodes a color class
                # can hold hundreds of nodes, and per-task dispatch
                # overhead was beating the scoring work itself.  Slicing
                # is order-preserving, so the zip below and the serial
                # reference stay byte-identical.
                chunk = max(1, -(-len(cls) // (sweep_workers * 2)))
                batches = [cls[b:b + chunk]
                           for b in range(0, len(cls), chunk)]
                picks = [p for sub in pool.map(
                    lambda ns: [rank_node(n, all_names, 1) for n in ns],
                    batches) for p in sub]
            else:
                picks = [rank_node(n, all_names, 1) for n in cls]
            for node, (top, evaluated, rejected) in zip(cls, picks):
                res.evaluated += evaluated
                res.rejected_constraint += rejected
                best, best_unroll = (top[0][1], top[0][2]) if top else ({}, {})
                prev = dict(node.axis_map)
                est.apply(node.name, best, best_unroll)
                if dict(node.axis_map) != prev:
                    changed.append(node.name)
        return changed, len(classes)

    def converge(dirty: set[str], max_sweeps: int, tag: str,
                 within: set[str] | None = None,
                 until: float | None = None) -> None:
        """Full-order coordinate descent to a fixpoint: every sweep covers
        the *whole* current frontier (no first-change short-circuit) and
        re-dirties the affected sets of whatever changed.  Under a
        ``deadline`` each sweep boundary is an interruption point —
        committed state is always a complete, consistent assignment.

        ``within`` restricts the descent to one region: the frontier and
        every re-dirtied set are intersected with it, so nodes outside
        are never touched (the hierarchical DSE's inner level — the
        complement is frozen by protocol).  ``until`` is a sub-deadline
        for this call only (a region's share of the inner budget);
        ``res.budget_expired`` is raised only when the *global* deadline
        is the one that passed."""
        stop_at = deadline if until is None else until
        for s in range(max_sweeps):
            if stop_at is not None and time.perf_counter() >= stop_at:
                if deadline is not None \
                        and time.perf_counter() >= deadline:
                    res.budget_expired = True
                res.log.append(f"{tag} sweep{s + 1}: budget expired")
                break
            frontier = [n for n in ordered if n.name in dirty]
            if not frontier:
                break
            changed, ncolors = sweep(frontier)
            res.log.append(
                f"{tag} sweep{s + 1}: {len(changed)}/{len(frontier)} "
                f"nodes changed "
                f"({f'{ncolors} colors' if ncolors else 'serial'})")
            if not changed:
                break
            dirty = set()
            for name in changed:
                dirty |= affected[name]
            if within is not None:
                dirty &= within

    try:
        # ---- greedy phase: the paper's most-connected-first pass, then
        # coordinate descent (sweeps re-run each node's DSE with *all*
        # neighbours parallelized, converging the chain onto one layout basin
        # — greedy one-pass can lock attention into SP while the FFN picks TP,
        # paying a reshard at every boundary).
        done: set[str] = set()
        if warm_start is not None:
            # Warm seeding: covered nodes take their cached assignment
            # (sanitized onto this mesh — an empty map is still a
            # deliberate cached choice, "replicated"), uncovered nodes
            # run the normal constrained scan against the seeded state.
            res.warm = True
            res.dse_mode = "warm"
            for node in ordered:
                frag = warm_start.get(node.name)
                if frag is not None:
                    prop = _sanitize_warm(
                        node, frag[0], res.pf[node.name], mesh)
                    est.apply(node.name, prop)
                    res.warm_covered += 1
                else:
                    dse_node(node, done)
                done.add(node.name)
            res.log.append(
                f"warm seed: {res.warm_covered}/{len(ordered)} nodes "
                f"covered by cached assignment")
        else:
            for node in ordered:
                dse_node(node, done)
                done.add(node.name)
        converge(set(all_names), max_sweeps=4,
                 tag="warm" if warm_start is not None else "greedy")
        greedy_snap = est.snapshot()
        greedy_key = (est.total_s, est.hbm_bytes_per_device)
        res.greedy_total_s = greedy_key[0]

        def apply_uniform(assign: dict[str, tuple[str, ...]]) -> None:
            """One joint move of radius ∞: the same axis→dim layout applied to
            every node at once (routed through the incremental engine, so each
            candidate costs O(edges), not a batch re-estimate).  Nodes whose
            quantized proposal already matches their live assignment are
            skipped — consecutive family members share most of their
            per-node layouts, so sweeps over the family are diff-priced."""
            for n in sched.nodes:
                prop = _uniform_proposal(n, assign, res.pf[n.name], mesh)
                if prop != n.axis_map:
                    est.apply(n.name, prop)

        def uniform_candidates() -> list[dict[str, tuple[str, ...]]]:
            return _uniform_assignments(sched)

        def neighborhood(origin: str, radius: int) -> list[str]:
            """Nodes within ``radius`` hops of ``origin`` in the affected-set
            graph (origin excluded), in DSE order."""
            seen = {origin}
            frontier = {origin}
            for _ in range(radius):
                frontier = {m for x in frontier for m in affected[x]} - seen
                seen |= frontier
            seen.discard(origin)
            return [n.name for n in ordered if n.name in seen]

        # ---- warm finish: the beam is what makes cold DSE expensive, so
        # the warm path replaces it with two cheap scans over already-
        # enumerated families — (a) the warm_entries fragments (region
        # summaries of the donor plan) as whole-schedule alternatives,
        # (b) the uniform-assignment floor family — keeping strict
        # improvements only.  Everything after the converged warm-greedy
        # state runs inside an error boundary; the converged state is the
        # guaranteed floor.
        if warm_start is not None:
            warm_key = (est.total_s, est.hbm_bytes_per_device)
            warm_snap = est.snapshot()
            res.greedy_total_s = warm_key[0]
            best: list = [warm_key, warm_snap]
            try:
                for frag in (warm_entries or [])[:16]:
                    est.restore(best[1])
                    changed = 0
                    for nm, (am, _ur) in frag.items():
                        if nm not in all_names:
                            continue
                        node = sched.node(nm)
                        prop = _sanitize_warm(node, am, res.pf[nm], mesh)
                        if prop != node.axis_map:
                            est.apply(nm, prop)
                            changed += 1
                    if not changed:
                        continue
                    key = (est.total_s, est.hbm_bytes_per_device)
                    if key < best[0]:
                        best[:] = [key, est.snapshot()]
                for a in uniform_candidates():
                    apply_uniform(a)
                    key = (est.total_s, est.hbm_bytes_per_device)
                    if key < best[0]:
                        best[:] = [key, est.snapshot()]
                est.restore(best[1])
                if best[0] < warm_key:
                    # An alternative won; one short re-converge around it
                    # (restored if it somehow regresses).
                    converge(set(all_names), max_sweeps=2,
                             tag="warm-refine")
                    k2 = (est.total_s, est.hbm_bytes_per_device)
                    if best[0] < k2:
                        est.restore(best[1])
                    res.log.append(
                        f"warm alt: {warm_key[0]*1e3:.3f} -> "
                        f"{min(k2, best[0])[0]*1e3:.3f}ms")
            except Exception as e:
                res.degraded.append(
                    f"warm finish failed ({type(e).__name__}: {e}); "
                    "restored converged warm seed")
                res.log.append(res.degraded[-1])
                est.restore(warm_snap)

        # ---- beam phase: joint multi-node proposals, flat or two-level.
        # The whole phase — region partition, seeding, rounds, refinement
        # — runs inside one error boundary: the beam is an *optimization*
        # over the converged greedy state, never a correctness
        # dependency, so any failure inside it restores the best
        # fully-committed snapshot seen so far (at worst the greedy one)
        # and the compile proceeds.
        elif ca and beam_width > 1:
            # Best fully-committed (key, snapshot) seen anywhere in the
            # phase — the error boundary restores it on failure.
            safe: list = [greedy_key, greedy_snap]

            def expired() -> bool:
                if deadline is not None and time.perf_counter() >= deadline:
                    res.budget_expired = True
                    return True
                return False

            region_specs: list[RegionSpec] = []
            if dse_mode == "hierarchical":
                try:
                    region_specs = dse_regions(sched)
                except Exception as e:
                    res.log.append(
                        f"region partition failed "
                        f"({type(e).__name__}: {e}); flat beam")
                if len(region_specs) < 2:
                    # Single-region schedules take the flat path —
                    # bit-identical to dse_mode="flat" by construction.
                    region_specs = []

            def run_flat() -> None:
                """Whole-schedule beam over joint moves — the original
                flat search, kept as the differential-testing oracle
                (``dse_mode="flat"``) and the single-region path."""
                def sig(snap: Snapshot):
                    return tuple(sorted(
                        (nm, tuple(sorted((d, axes)
                                          for d, axes in am.items())))
                        for nm, (am, _ur) in snap.items()))

                states: dict[tuple, tuple[tuple, Snapshot]] = {}

                def add_state(snap: Snapshot, key: tuple) -> None:
                    s = sig(snap)
                    if s not in states or key < states[s][0]:
                        states[s] = (key, snap)

                add_state(greedy_snap, greedy_key)
                for a in uniform_candidates():
                    apply_uniform(a)
                    key = (est.total_s, est.hbm_bytes_per_device)
                    add_state(est.snapshot(), key)
                beam = sorted(states.values(),
                              key=lambda t: t[0])[:beam_width]
                best_key = beam[0][0]
                if best_key < safe[0]:
                    safe[:] = beam[0]
                res.log.append(
                    f"beam init: {len(states)} states, best "
                    f"{best_key[0]*1e3:.3f}ms"
                    f" (greedy {greedy_key[0]*1e3:.3f}ms)")

                expand_states = max(1, beam_width // 2)
                max_origins = 4
                joint_runners = 2
                for rnd in range(beam_rounds):
                    if expired():
                        res.log.append(
                            f"beam round {rnd + 1}: budget expired")
                        break
                    successors: dict[tuple, tuple[tuple, Snapshot]] = {
                        sig(snap): (key, snap) for key, snap in beam}
                    for key, snap in beam[:expand_states]:
                        if expired():
                            break
                        est.restore(snap)
                        mm = est.mismatched_nodes()
                        origins = sorted(
                            (n for n in ordered if proposals_for(n)),
                            key=lambda n: (n.name not in mm,
                                           -est.node_latency_s(n.name)))
                        for node in origins[:max_origins]:
                            ranked, evaluated, rejected = rank_node(
                                node, all_names, joint_runners + 1)
                            res.evaluated += evaluated
                            res.rejected_constraint += rejected
                            tried = 0
                            for _pkey, prop, unroll in ranked:
                                if prop == node.axis_map:
                                    continue
                                if tried >= joint_runners:
                                    break
                                fault_point("dse.joint")
                                tried += 1
                                res.joint_moves += 1
                                est.apply(node.name, prop, unroll)
                                for m in neighborhood(node.name,
                                                      joint_radius):
                                    dse_node(sched.node(m), all_names)
                                skey = (est.total_s,
                                        est.hbm_bytes_per_device)
                                succ = est.snapshot()
                                s = sig(succ)
                                if s not in successors \
                                        or skey < successors[s][0]:
                                    successors[s] = (skey, succ)
                                est.restore(snap)
                    beam = sorted(successors.values(),
                                  key=lambda t: t[0])[:beam_width]
                    res.log.append(
                        f"beam round {rnd + 1}: {len(successors)} states, "
                        f"best {beam[0][0][0]*1e3:.3f}ms")
                    if beam[0][0] < safe[0]:
                        safe[:] = beam[0]
                    if not beam[0][0] < best_key:
                        break
                    best_key = beam[0][0]
                res.beam_states = len(states) + res.joint_moves

                # Refine the winner with full sweeps; keep whichever of
                # {refined, pre-refinement best, greedy} scores best — beam
                # QoR can therefore never fall below greedy QoR.
                est.restore(beam[0][1])
                converge(set(all_names), max_sweeps=4, tag="beam-refine")
                final_key = (est.total_s, est.hbm_bytes_per_device)
                if beam[0][0] < final_key:
                    est.restore(beam[0][1])
                    final_key = beam[0][0]
                if greedy_key < final_key:
                    est.restore(greedy_snap)

            def run_hier() -> None:
                """Two-level DSE: per-region inner beams composed by an
                inter-region outer beam (HIDA §4 — solve each region's
                local design space, compose summaries one level up)."""
                res.dse_mode = "hierarchical"
                res.regions = len(region_specs)
                t_inner0 = time.perf_counter()
                conn_by_edge = {(c.src, c.dst, c.buffer): c for c in conns}
                uniforms = uniform_candidates()

                # Score the global uniform family once: the outer level
                # seeds with these snapshots verbatim (the flat beam's
                # uniform seeds), and the inner level quantizes only the
                # strongest few per region — quantizing all ~O(dims ×
                # axes) members per region is where a naive inner level
                # spends most of its time.
                scored_uniforms: list[tuple[tuple, Snapshot, dict]] = []
                for a in uniforms:
                    if expired():
                        break
                    apply_uniform(a)
                    scored_uniforms.append(
                        ((est.total_s, est.hbm_bytes_per_device),
                         est.snapshot(), a))
                est.restore(greedy_snap)
                inner_uniforms = [
                    a for _k, _s, a in sorted(
                        scored_uniforms, key=lambda t: t[0])[:6]]
                region_topk = 4
                inner_origins = 2
                # Bound the *total* deepening work, not the per-region
                # work: many small regions each get a shallow beam, few
                # large regions get the full flat-beam expansion width.
                inner_seeds = max(1, min(beam_width // 2,
                                         (2 * beam_width)
                                         // len(region_specs)))
                joint_runners = 2

                # Budget split: the inner level gets INNER_SHARE of the
                # remaining budget, sliced across regions on an absolute
                # timeline (a region finishing early donates its slack to
                # the next); the outer level keeps the rest, and the
                # adaptive re-search below spends outer leftovers on the
                # most uncertain region.
                INNER_SHARE = 0.6
                if deadline is not None:
                    inner_until = min(
                        deadline,
                        t_inner0
                        + max(0.0, deadline - t_inner0) * INNER_SHARE)
                else:
                    inner_until = None

                summaries: list[RegionSummary] = []
                for spec in region_specs:
                    t_r = time.perf_counter()
                    r_until = None
                    if inner_until is not None:
                        r_until = (t_inner0
                                   + (inner_until - t_inner0)
                                   * (spec.index + 1) / len(region_specs))

                    def r_expired() -> bool:
                        return (expired()
                                or (r_until is not None
                                    and time.perf_counter() >= r_until))

                    rnames = set(spec.nodes)
                    view = est.region_view(spec.nodes)
                    r_nodes = [n for n in ordered if n.name in rnames]
                    greedy_frag = view.snapshot()
                    entries: dict[tuple, RegionEntry] = {}

                    def note(origin: str) -> None:
                        frag = view.snapshot()
                        e = RegionEntry(
                            assignment=frag, total_s=est.total_s,
                            delta_s=est.total_s - greedy_key[0],
                            hbm_bytes=est.hbm_bytes_per_device,
                            region_hbm_bytes=view.hbm_bytes,
                            origin=origin)
                        k = _frag_sig(frag)
                        old = entries.get(k)
                        if old is None:
                            entries[k] = e
                        elif e.key() < old.key():
                            # Same fragment against the same complement
                            # scores identically; keep the greedy label.
                            if old.origin == "greedy":
                                e.origin = "greedy"
                            entries[k] = e

                    degraded_note = ""
                    try:
                        fault_point("dse.inner")
                        note("greedy")
                        # Region quantizations of the strongest uniform
                        # family members (the full family still seeds
                        # the outer level as whole-schedule states).
                        seen_frags: set = set()
                        for a in inner_uniforms:
                            frag: Snapshot = {}
                            for n in r_nodes:
                                prop = _uniform_proposal(
                                    n, a, res.pf[n.name], mesh)
                                unroll = {
                                    d: math.prod(mesh.size(x)
                                                 for x in axes)
                                    for d, axes in prop.items()}
                                frag[n.name] = (prop, unroll)
                            k = _frag_sig(frag)
                            if k in seen_frags:
                                continue
                            seen_frags.add(k)
                            view.restore(frag)
                            note("uniform")
                        # Deepen the strongest entries: region-scoped
                        # coordinate descent + within-region joint moves.
                        seeds = sorted(entries.values(),
                                       key=RegionEntry.key)[:inner_seeds]
                        for seed in seeds:
                            if r_expired():
                                break
                            view.restore(seed.assignment)
                            if seed.origin != "greedy":
                                # (The greedy entry is already a global
                                # coordinate-descent fixpoint.)  One
                                # region-scoped sweep: the outer winner
                                # gets the full refinement afterwards.
                                converge(set(rnames), max_sweeps=1,
                                         tag=f"inner r{spec.index}",
                                         within=rnames, until=r_until)
                                note("search")
                            base = view.snapshot()
                            mm = est.mismatched_nodes()
                            origins = sorted(
                                (n for n in r_nodes
                                 if proposals_for(n)),
                                key=lambda n: (
                                    n.name not in mm,
                                    -est.node_latency_s(n.name)))
                            for node in origins[:inner_origins]:
                                if r_expired():
                                    break
                                ranked, evaluated, rejected = rank_node(
                                    node, all_names, joint_runners + 1)
                                res.evaluated += evaluated
                                res.rejected_constraint += rejected
                                tried = 0
                                for _pk, prop, unroll in ranked:
                                    if prop == node.axis_map:
                                        continue
                                    if tried >= joint_runners:
                                        break
                                    tried += 1
                                    res.joint_moves += 1
                                    est.apply(node.name, prop, unroll)
                                    for m in neighborhood(node.name,
                                                          joint_radius):
                                        if m in rnames:
                                            dse_node(sched.node(m),
                                                     all_names)
                                    note("search")
                                    view.restore(base)
                    except Exception as exc:
                        degraded_note = f"{type(exc).__name__}: {exc}"
                        res.degraded.append(
                            f"inner DSE failed on region {spec.index} "
                            f"({degraded_note}); region pinned to its "
                            "greedy/uniform entries")
                        res.log.append(res.degraded[-1])
                    finally:
                        # The complement of later regions must see this
                        # region at greedy — entries are scored against
                        # an all-greedy complement by protocol.
                        view.restore(greedy_frag)
                    if not entries:
                        # dse.inner fired before the greedy entry landed.
                        entries[_frag_sig(greedy_frag)] = RegionEntry(
                            assignment=greedy_frag,
                            total_s=greedy_key[0], delta_s=0.0,
                            hbm_bytes=greedy_key[1],
                            region_hbm_bytes=view.hbm_bytes,
                            origin="greedy")
                    ranked_entries = sorted(entries.values(),
                                            key=RegionEntry.key)
                    top = ranked_entries[:region_topk]
                    if not any(e.origin == "greedy" for e in top):
                        top.append(next(e for e in ranked_entries
                                        if e.origin == "greedy"))
                    summaries.append(RegionSummary(
                        index=spec.index, nodes=spec.nodes, entries=top,
                        boundary_sig=_region_boundary_sig(
                            spec, conn_by_edge, sched.buffers),
                        hbm_bytes=view.hbm_bytes,
                        inner_s=time.perf_counter() - t_r,
                        degraded=degraded_note))
                res.region_summaries = summaries
                res.inner_dse_s = time.perf_counter() - t_inner0
                res.log.append(
                    "inner level: "
                    + ", ".join(f"r{s.index}:{len(s.entries)}e"
                                + ("!" if s.degraded else "")
                                for s in summaries))

                # ---- outer level: compose one entry per region.  A
                # combo is a tuple of entry indices; scoring re-applies
                # only the differing fragments (O(diff × deg) via
                # est.restore) — boundary resharding and the composed
                # footprint come out of the same topology-cached edge
                # terms the flat beam scores with.
                t_outer0 = time.perf_counter()
                fault_point("dse.outer")
                combo_keys: dict[tuple[int, ...], tuple] = {}

                def eval_combo(combo: tuple[int, ...]) -> tuple:
                    key = combo_keys.get(combo)
                    if key is not None:
                        return key
                    snap = dict(greedy_snap)
                    for summ, ei in zip(summaries, combo):
                        snap.update(summ.entries[ei].assignment)
                    est.restore(snap)
                    key = (est.total_s, est.hbm_bytes_per_device)
                    combo_keys[combo] = key
                    return key

                greedy_combo = tuple(s.greedy_index() for s in summaries)
                eval_combo(greedy_combo)
                eval_combo(tuple(0 for _ in summaries))
                # Global uniform states: a truncated family member may
                # not be expressible as a combo, so seed the flat beam's
                # uniform states directly (scored once, up front) — the
                # outer winner can never lose to a uniform layout.
                extra: list[tuple[tuple, Snapshot]] = [
                    (k, snap) for k, snap, _a in scored_uniforms]

                expand_states = max(1, beam_width // 2)
                # Regions with the widest entry spread first: that is
                # where composition choices move the total the most.
                region_order = sorted(
                    range(len(summaries)),
                    key=lambda r: (-(summaries[r].entries[-1].total_s
                                     - summaries[r].entries[0].total_s),
                                   r))
                for rnd in range(beam_rounds):
                    if expired():
                        res.log.append(
                            f"outer round {rnd + 1}: budget expired")
                        break
                    prev_best = min(combo_keys.values())
                    frontier = sorted(
                        combo_keys.items(),
                        key=lambda kv: kv[1])[:expand_states]
                    for combo, _k in frontier:
                        if expired():
                            break
                        for r in region_order:
                            for ei in range(len(summaries[r].entries)):
                                if ei == combo[r]:
                                    continue
                                cand = (combo[:r] + (ei,)
                                        + combo[r + 1:])
                                if cand in combo_keys:
                                    continue
                                fault_point("dse.outer")
                                eval_combo(cand)
                    best_now = min(combo_keys.values())
                    res.log.append(
                        f"outer round {rnd + 1}: {len(combo_keys)} "
                        f"combos, best {best_now[0]*1e3:.3f}ms")
                    if not best_now < prev_best:
                        break
                res.beam_states += len(combo_keys) + len(extra)

                # Winner = best of every combo and every uniform seed.
                win_combo = min(combo_keys,
                                key=lambda c: combo_keys[c])
                win_key = combo_keys[win_combo]
                win_snap = dict(greedy_snap)
                for summ, ei in zip(summaries, win_combo):
                    win_snap.update(summ.entries[ei].assignment)
                for key, snap in extra:
                    if key < win_key:
                        win_key, win_snap = key, snap
                if win_key < safe[0]:
                    safe[:] = [win_key, win_snap]
                res.log.append(
                    f"outer level: best {win_key[0]*1e3:.3f}ms "
                    f"(greedy {greedy_key[0]*1e3:.3f}ms)")

                # Full-schedule refinement of the winner; keep the best
                # of {refined, winner, greedy} — hierarchical QoR can
                # never fall below greedy QoR, exactly like the flat
                # beam.
                est.restore(win_snap)
                converge(set(all_names), max_sweeps=4,
                         tag="outer-refine")
                final_key = (est.total_s, est.hbm_bytes_per_device)
                if win_key < final_key:
                    est.restore(win_snap)
                    final_key = win_key
                if greedy_key < final_key:
                    est.restore(greedy_snap)
                    final_key = greedy_key
                if final_key < safe[0]:
                    safe[:] = [final_key, est.snapshot()]

                # Adaptive split: whatever outer budget is left goes to
                # deepening the most uncertain region (widest entry
                # spread) from the final composition.
                if deadline is not None and summaries \
                        and not expired():
                    r = region_order[0]
                    base_snap = est.snapshot()
                    base_key = final_key
                    converge(set(summaries[r].nodes), max_sweeps=3,
                             tag=f"outer-deepen r{r}",
                             within=set(summaries[r].nodes))
                    k2 = (est.total_s, est.hbm_bytes_per_device)
                    if k2 < base_key:
                        res.log.append(
                            f"outer-deepen r{r}: {base_key[0]*1e3:.3f}"
                            f" -> {k2[0]*1e3:.3f}ms")
                        if k2 < safe[0]:
                            safe[:] = [k2, est.snapshot()]
                    else:
                        est.restore(base_snap)
                res.outer_dse_s = time.perf_counter() - t_outer0

            try:
                if region_specs:
                    run_hier()
                else:
                    run_flat()
            except Exception as e:
                res.degraded.append(
                    f"beam phase failed ({type(e).__name__}: {e}); "
                    "restored best pre-failure snapshot")
                res.log.append(res.degraded[-1])
                est.restore(safe[1])
        elif seed_uniform:
            # Legacy pre-beam escape hatch (deprecated): best uniform
            # assignment, then two refinement sweeps over the full node order
            # (an earlier version short-circuited at the first changed node).
            best_state = est.snapshot()
            best_cost = est.total_s
            for a in uniform_candidates():
                apply_uniform(a)
                cost = est.total_s
                if cost < best_cost:
                    best_cost, best_state = cost, est.snapshot()
                    res.log.append(f"uniform-seed: {a} -> {cost*1e3:.2f}ms")
            est.restore(best_state)
            for _ in range(2):
                if not any([dse_node(n, all_names) for n in ordered]):
                    break
            if est.total_s > best_cost:
                est.restore(best_state)

    finally:
        if pool is not None:
            pool.shutdown()
    for node in ordered:
        res.log.append(
            f"{node.name}: pf={res.pf[node.name]} "
            f"factors={node.unroll} axes={node.axis_map}")
    res.cost = est.schedule_cost()
    return res
