"""QoR estimator: TPU v5e roofline model (paper Section 6.5 uses the
ScaleHLS Vitis QoR model; the TPU port replaces DSP/BRAM/LUT with the
compute / HBM / ICI roofline triple).

The estimator scores a Structural schedule under a candidate
parallelization (per-node ``unroll`` factors + mesh-axis assignment):

* compute term   = node FLOPs / (parallel_factor · peak FLOP/s)
* memory term    = node HBM bytes touched / (parallel_factor · HBM BW)
* collective term = resharding + sync bytes / (chips · ICI BW)

Node latency is ``max`` of the three (roofline); schedule latency is the
sum over nodes (one XLA step) and the pipeline initiation interval is the
critical node (paper: "the critical task determines the overall achievable
performance").  The same constants drive EXPERIMENTS.md §Roofline, where
the estimate is cross-checked against ``compiled.cost_analysis()`` and
collective bytes parsed from post-SPMD HLO.

``estimate()`` here is the **batch reference**: a single full-schedule
pass, O(nodes × ops).  The parallelizer's DSE scores thousands of
single-node proposals and therefore runs on
:class:`repro_torch.core.incremental.IncrementalEstimator`, which caches the
unroll-independent structure and re-scores one proposal in O(deg) —
bit-identical to this module by construction (asserted across every
config by ``tests/test_incremental.py``).  Changes to the cost model must
be made in *both* places; the equivalence tests will catch a drift.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .ir import Buffer, Node, Schedule

# TPU v5e per-chip constants (assignment-specified).  These are the
# reference estimator's assumed inputs, kept so that this copy derives the
# reference's plans (``tests/goldens/pre_dse``).  They are neither a
# measurement nor a rating of the card the port runs on; moving to the
# H100's figures changes the plans and needs goldens of its own.
PEAK_FLOPS = 197e12          # bf16 FLOP/s
HBM_BW = 819e9               # bytes/s
ICI_BW = 50e9                # bytes/s per link
FIXED_NODE_OVERHEAD_S = 2e-6  # kernel launch / fusion boundary overhead


@dataclass(frozen=True)
class MeshSpec:
    """Ordered mesh axes, e.g. (("data", 16), ("model", 16))."""

    axes: tuple[tuple[str, int], ...]

    @property
    def chips(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def size(self, axis: str) -> int:
        for a, s in self.axes:
            if a == axis:
                return s
        raise KeyError(axis)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)


SINGLE_POD = MeshSpec((("data", 16), ("model", 16)))
MULTI_POD = MeshSpec((("pod", 2), ("data", 16), ("model", 16)))


def node_parallel_factor(node: Node) -> int:
    f = 1
    for v in node.unroll.values():
        f *= v
    return max(f, 1)


def buffer_shard_factor(buf: Buffer, node: Node) -> int:
    """How many ways this node's factors shard the buffer, via its access
    map (a loop dim only shards the buffer axes it indexes)."""
    am = node.access_for(buf.name)
    if am is None:
        return 1
    f = 1
    for axis, (dim, _stride) in enumerate(am.entries):
        if dim is not None and dim in node.unroll:
            f *= min(node.unroll[dim], buf.shape[axis])
    return max(f, 1)


def tree_sum(values) -> float:
    """Sum floats in a fixed perfect-binary-tree order.

    The reduction shape depends only on ``len(values)`` (leaves padded
    with ``0.0`` to the next power of two, then summed pairwise level by
    level), never on the values.  Two properties make this the summation
    contract of the whole QoR layer:

    * a *point update* recomputes only the leaf-to-root path and lands on
      bit-exactly the same root a from-scratch reduction would produce —
      which is what lets :class:`~repro_torch.core.incremental.IncrementalEstimator`
      maintain ``total_s`` / ``hbm_bytes_per_device`` as O(log n)
      segment trees while staying bit-identical to this batch path
      (sequential left-to-right ``sum()`` has no such property: a
      running total diverges from a re-sum after the first non-exact
      add);
    * the tree depth is O(log n), so the roundoff of a 10k-node total is
      bounded by ~14 adds instead of ~10k.

    Every totals consumer (batch ``estimate()``, the incremental engine,
    ``score()``) must reduce through this same shape — mixing orders
    breaks the engine-vs-batch bitwise equivalence pinned by
    ``tests/test_incremental.py``.
    """
    level = list(values)
    if not level:
        return 0.0
    size = 1
    while size < len(level):
        size *= 2
    level.extend([0.0] * (size - len(level)))
    while len(level) > 1:
        level = [level[i] + level[i + 1] for i in range(0, len(level), 2)]
    return level[0]


@dataclass
class NodeCost:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def latency_s(self) -> float:
        return max(self.compute_s, self.memory_s,
                   self.collective_s) + FIXED_NODE_OVERHEAD_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


@dataclass
class ScheduleCost:
    nodes: dict[str, NodeCost] = field(default_factory=dict)
    reshard_bytes: int = 0
    sync_bytes: int = 0
    hbm_bytes_per_device: int = 0

    @property
    def total_s(self) -> float:
        return tree_sum([c.latency_s for c in self.nodes.values()])

    @property
    def critical_s(self) -> float:
        """Pipeline initiation interval: the critical node."""
        return max((c.latency_s for c in self.nodes.values()), default=0.0)

    @property
    def dominant(self) -> str:
        agg = {"compute": 0.0, "memory": 0.0, "collective": 0.0}
        for c in self.nodes.values():
            agg["compute"] += c.compute_s
            agg["memory"] += c.memory_s
            agg["collective"] += c.collective_s
        return max(agg, key=agg.get)


def _bytes_touched(node: Node, sched: Schedule) -> float:
    """Per-device HBM traffic of the node: every argument buffer, sharded
    by this node's factors (weights stream once; activations read+write),
    amortized by the node's per-iteration repeat."""
    total = 0.0
    for v in node.args:
        buf = sched.buffers.get(v)
        if buf is None:
            continue
        total += buf.bytes / buffer_shard_factor(buf, node)
    return total * node.repeat


def _op_out_shard(op, out: str, unroll: dict[str, int]) -> int:
    am = op.access.get(out)
    if am is None:
        return 1
    f = 1
    for dim, _ in am.entries:
        if dim is not None:
            f *= unroll.get(dim, 1)
    return max(f, 1)


def _reduction_bytes(node: Node, sched: Schedule) -> float:
    """Intra-node collective cost: sharding a *reduction* loop dim (one
    that appears in an input's access but no output's — a matmul
    contraction, a norm reduction, a dispatch scatter axis) forces an
    all-reduce / all-to-all of the op's outputs across that axis.  This is
    the cost that makes contraction-dim sharding lose the DSE unless the
    dim is genuinely the only parallelism left."""
    total = 0.0
    for op in node.body:
        out_dims: set[str] = set()
        for v in op.outs:
            am = op.access.get(v)
            if am:
                out_dims.update(d for d, _ in am.entries if d)
        in_dims: set[str] = set()
        for v in op.ins:
            am = op.access.get(v)
            if am:
                in_dims.update(d for d, _ in am.entries if d)
        red = (in_dims - out_dims) | set(op.attrs.get("reduce", ()))
        k = 1
        for d in red:
            k *= node.unroll.get(d, 1)
        if k <= 1:
            continue
        out_bytes = sum(
            sched.value_bytes.get(v, 0) / _op_out_shard(op, v, node.unroll)
            for v in op.outs)
        total += 2.0 * out_bytes * (k - 1) / k * op.repeat
    return total


class EstimateContext:
    """Precomputed schedule topology — parallelize() evaluates hundreds of
    proposals per node, so the O(buffers·nodes²) edge scan is hoisted."""

    def __init__(self, sched: Schedule):
        # One topology() call for the whole build: consumers_of() would
        # re-validate the topology cache (an O(nodes) signature walk) per
        # buffer, turning this constructor O(buffers·nodes) at 1k+ nodes.
        topo = sched.topology()
        self.edges = list(topo.edges)
        self.consumers = {b: list(topo.consumers.get(b, ()))
                          for b in sched.buffers}
        self.weight_buffers = [b for b, buf in sched.buffers.items()
                               if buf.is_weight]
        self.by_name = {n.name: n for n in sched.nodes}


def _reshard_bytes(sched: Schedule, ctx: EstimateContext) -> dict[str, int]:
    """Per-consumer-node resharding bytes: when a shared buffer's effective
    sharding differs between producer and consumer, XLA inserts an
    all-to-all / all-gather whose per-device payload is roughly the local
    shard (CA's divisibility constraint is what avoids this)."""
    out: dict[str, int] = {}
    for src, dst, bname in ctx.edges:
        p = ctx.by_name[src]
        c = ctx.by_name[dst]
        buf = sched.buffers[bname]
        pam, cam = p.access_for(bname), c.access_for(bname)
        if pam is None or cam is None:
            continue
        mismatch = False
        for axis in range(len(buf.shape)):
            pdim = pam.entries[axis][0]
            cdim = cam.entries[axis][0]
            paxes = tuple(p.axis_map.get(pdim, ())) if pdim else ()
            caxes = tuple(c.axis_map.get(cdim, ())) if cdim else ()
            # Strict: any layout difference on a shared buffer pays a
            # reshard (GSPMD all-gathers / all-to-alls at the boundary);
            # this is what drives CA chains to align fully instead of
            # merely being divisible.
            if paxes != caxes:
                mismatch = True
        if mismatch:
            shard = buf.bytes // max(
                buffer_shard_factor(buf, p), 1)
            out[dst] = out.get(dst, 0) + shard
    return out


def _weight_sync_bytes(sched: Schedule, mesh: MeshSpec,
                       training: bool, ctx: EstimateContext
                       ) -> dict[str, int]:
    """Gradient reduce-scatter + all-gather bytes per producing node for
    weight buffers, over the mesh axes that do NOT shard the weight."""
    if not training:
        return {}
    out: dict[str, int] = {}
    for bname in ctx.weight_buffers:
        buf = sched.buffers[bname]
        consumers = ctx.consumers.get(bname, ())
        if not consumers:
            continue
        n = consumers[0]
        shard = buf.bytes // max(buffer_shard_factor(buf, n), 1)
        # The gradient must be summed over every mesh axis that does NOT
        # shard the weight itself (axes assigned to dims the weight's
        # access map does not touch — i.e. pure batch/seq parallelism).
        am = n.access_for(bname)
        w_dims = {d for d, _ in am.entries if d} if am else set()
        w_axes = {a for d in w_dims for a in n.axis_map.get(d, ())}
        sync_ways = 1
        for a, s in mesh.axes:
            if a not in w_axes:
                sync_ways *= s
        if sync_ways > 1:
            # reduce-scatter + all-gather ≈ 2·bytes·(k-1)/k per device,
            # amortized to per-iteration cost like everything else.
            out[n.name] = out.get(n.name, 0) + int(
                2 * shard * (sync_ways - 1) / sync_ways * n.repeat)
    return out


def estimate(sched: Schedule, mesh: MeshSpec, training: bool = True,
             ctx: EstimateContext | None = None) -> ScheduleCost:
    cost = ScheduleCost()
    ctx = ctx or EstimateContext(sched)
    reshard = _reshard_bytes(sched, ctx)
    sync = _weight_sync_bytes(sched, mesh, training, ctx)
    hbm: list[float] = []
    for node in sched.nodes:
        pf = node_parallel_factor(node)
        flops = node.intensity()
        nbytes = _bytes_touched(node, sched)
        coll = (reshard.get(node.name, 0) + sync.get(node.name, 0)
                + _reduction_bytes(node, sched))
        cost.nodes[node.name] = NodeCost(
            compute_s=flops / pf / PEAK_FLOPS,
            memory_s=nbytes / HBM_BW,
            collective_s=coll / ICI_BW,
        )
        hbm.append(nbytes)
    cost.reshard_bytes = sum(reshard.values())
    cost.sync_bytes = sum(sync.values())
    # Same tree shape as the incremental engine's nbytes segment tree —
    # see tree_sum's contract.
    cost.hbm_bytes_per_device = int(tree_sum(hbm))
    return cost


def roofline_terms(flops: float, bytes_hbm: float, bytes_coll: float,
                   chips: int) -> dict[str, float]:
    """The §Roofline triple for EXPERIMENTS.md, from dry-run totals."""
    return {
        "compute_s": flops / (chips * PEAK_FLOPS),
        "memory_s": bytes_hbm / (chips * HBM_BW),
        "collective_s": bytes_coll / (chips * ICI_BW),
    }
