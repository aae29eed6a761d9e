"""HIDA-IR: hierarchical dataflow intermediate representation.

This module ports the paper's two-level IR (Section 5) to a JAX-oriented
setting:

* **Functional dataflow** — ``Dispatch`` / ``Task`` operations with
  *transparent* regions and tensor (immutable-value) semantics.  Used by the
  algorithmic passes: dataflow construction (Alg. 1) and task fusion
  (Alg. 2).

* **Structural dataflow** — ``Schedule`` / ``Node`` operations with
  *isolated* regions, explicit per-argument memory effects, plus ``Buffer``
  (memory-mapped, ping-pong, carrying partition / tiling / placement
  attributes) and ``Stream`` (FIFO) values.  Used by the
  micro-architectural passes: multi-producer elimination (Alg. 3),
  data-path balancing (Section 6.4.2) and IA+CA parallelization (Alg. 4).

On TPU, a Structural ``Node`` becomes a region of the XLA program delimited
by sharding-constraint sites, a ``Buffer`` becomes an activation / weight
tensor whose ``partition`` attribute is realised as a ``PartitionSpec``,
and a ``Stream`` becomes a pipeline staging slot.  See DESIGN.md Section 2
for the full correspondence table.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Dtypes
# --------------------------------------------------------------------------

_DTYPE_BYTES = {
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "i8": 1, "u8": 1, "i16": 2, "i32": 4, "i64": 8, "bool": 1,
    "f8_e4m3": 1, "f8_e5m2": 1,
}


def dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES[dtype]


# --------------------------------------------------------------------------
# Values: tensors (Functional) and buffers / streams (Structural)
# --------------------------------------------------------------------------

@dataclass
class TensorValue:
    """An immutable SSA tensor in the Functional dataflow.

    ``dims`` names each axis with the *logical* loop dimension that produces
    it (e.g. ``("batch", "seq", "d_model")``).  These names are what the
    connection analysis (Section 6.5 step 1) aligns across nodes.
    """

    name: str
    shape: tuple[int, ...]
    dtype: str = "bf16"
    dims: tuple[str, ...] = ()
    is_weight: bool = False

    def __post_init__(self) -> None:
        if self.dims and len(self.dims) != len(self.shape):
            raise ValueError(
                f"tensor {self.name}: dims {self.dims} rank != shape {self.shape}")
        if not self.dims:
            self.dims = tuple(f"d{i}" for i in range(len(self.shape)))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def bytes(self) -> int:
        return self.size * dtype_bytes(self.dtype)


class MemoryEffect:
    """Per-argument memory effect carried by a Structural ``Node``."""

    READ = "ro"
    WRITE = "wo"
    READ_WRITE = "rw"


@dataclass
class Buffer:
    """Memory-mapped buffer (Structural dataflow).

    ``stages`` is the ping-pong depth (paper Fig. 4 ``depth``); on TPU it is
    the number of staging slots the pipeline runtime rotates through (the
    "soft FIFO" of Section 6.4.2 uses ``stages > 2``).  ``partition`` holds
    per-dimension ``(kind, factor)`` pairs where kind is ``cyclic`` or
    ``block`` — realised as tiled HLO shardings.  ``tiling`` holds per-dim
    tile sizes consumed by the Pallas kernels' BlockSpecs.  ``placement`` is
    one of ``"onchip"`` (VMEM-resident working set), ``"hbm"`` or
    ``"external"`` (host / DCN staged).
    """

    name: str
    shape: tuple[int, ...]
    dtype: str = "bf16"
    dims: tuple[str, ...] = ()
    stages: int = 2
    partition: tuple[tuple[str, int], ...] = ()
    tiling: tuple[int, ...] = ()
    placement: str = "hbm"
    is_weight: bool = False
    # Set by plan.py: mesh-axis assignment per dim, e.g. (("data",), (), ("model",)).
    spec: tuple[tuple[str, ...], ...] | None = None

    def __post_init__(self) -> None:
        if not self.dims:
            self.dims = tuple(f"d{i}" for i in range(len(self.shape)))
        if not self.partition:
            self.partition = tuple(("block", 1) for _ in self.shape)
        if not self.tiling:
            self.tiling = tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def bytes(self) -> int:
        return self.size * dtype_bytes(self.dtype)

    @classmethod
    def from_tensor(cls, t: TensorValue, **kw) -> "Buffer":
        return cls(name=t.name, shape=t.shape, dtype=t.dtype, dims=t.dims,
                   is_weight=t.is_weight, **kw)


@dataclass
class Stream:
    """FIFO stream channel (Structural dataflow)."""

    name: str
    elem_shape: tuple[int, ...]
    dtype: str = "bf16"
    entries: int = 2        # FIFO depth
    is_token: bool = False  # 1-bit token stream for elastic ordering


# --------------------------------------------------------------------------
# Access maps — basis of permutation / scaling maps (Section 6.5 step 1)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AccessMap:
    """How an op's loop nest touches one tensor/buffer.

    For each tensor dimension, records ``(loop_dim_name | None, stride)``:
    ``loop_dim_name`` is the iteration dimension indexing that axis (None if
    the access broadcasts / reduces over it) and ``stride`` is the access
    stride as a Fraction (paper's scaling map; ``A[i*2][k]`` gives
    stride 2 on that axis).
    """

    entries: tuple[tuple[Optional[str], Fraction], ...]

    @classmethod
    def identity(cls, dims: Sequence[str]) -> "AccessMap":
        return cls(tuple((d, Fraction(1)) for d in dims))

    @classmethod
    def of(cls, *pairs: tuple[Optional[str], int | Fraction]) -> "AccessMap":
        return cls(tuple((d, Fraction(s)) for d, s in pairs))

    def loop_dim_for_axis(self, axis: int) -> Optional[str]:
        return self.entries[axis][0]

    def axes_for_loop_dim(self, dim: str) -> list[int]:
        return [i for i, (d, _) in enumerate(self.entries) if d == dim]


# --------------------------------------------------------------------------
# Operations
# --------------------------------------------------------------------------

_uid = itertools.count()


def fresh_name(prefix: str) -> str:
    return f"{prefix}_{next(_uid)}"


def reset_fresh_names(start: int = 0) -> None:
    """Reseed the global fresh-name counter (golden capture / tests only).

    Generated names (``task_N``, ``copy_N``, ``x_dup_N`` …) embed a global
    counter, so two runs of the same pipeline only produce identical IR
    when both start from the same counter value.  The golden-invariance
    sweep (``tests/test_rewrite.py``) resets before every build so the
    serialized schedules and plans are reproducible bit-for-bit."""
    global _uid
    _uid = itertools.count(start)


@dataclass
class Op:
    """A primitive computation in the dataflow graph.

    ``loop_dims`` is the iteration space (name → trip count); ``flops`` is
    the op intensity (Section 6.5: "number of operations contained by a
    node"); ``access`` maps each input/output value name to an AccessMap
    over ``loop_dims``.
    """

    name: str
    kind: str
    ins: list[str] = field(default_factory=list)
    outs: list[str] = field(default_factory=list)
    loop_dims: dict[str, int] = field(default_factory=dict)
    flops: int = 0
    access: dict[str, AccessMap] = field(default_factory=dict)
    attrs: dict = field(default_factory=dict)
    #: executions per super-block iteration — ops outside the repeated
    #: block (embed / lm-head / loss) amortize as 1/repeat_factor so the
    #: balancing and pipeline II reason about steady-state intensity.
    repeat: float = 1.0

    # --- region support (Tasks / Dispatches own regions) ------------------
    region: list["Op"] = field(default_factory=list)

    @property
    def has_region(self) -> bool:
        return bool(self.region)

    def walk(self, pre: bool = True) -> Iterator["Op"]:
        if pre:
            yield self
        for child in self.region:
            yield from child.walk(pre)
        if not pre:
            yield self

    def intensity(self) -> float:
        """Steady-state flops (amortized by ``repeat``) incl. nested ops."""
        own = self.flops * self.repeat
        if not self.region:
            return own
        return own + sum(c.intensity() for c in self.region)

    def all_ins(self) -> list[str]:
        """Region-transitive inputs (values read, not produced inside)."""
        if not self.region:
            return list(self.ins)
        produced: set[str] = set(self.outs)
        used: list[str] = list(self.ins)
        for c in self.region:
            for v in c.all_ins():
                if v not in produced and v not in used:
                    used.append(v)
            produced.update(c.all_outs())
        return used

    def all_outs(self) -> list[str]:
        if not self.region:
            return list(self.outs)
        outs = list(self.outs)
        for c in self.region:
            for v in c.all_outs():
                if v not in outs:
                    outs.append(v)
        return outs


def make_task(ops: Sequence[Op], name: str | None = None) -> Op:
    """Wrap ``ops`` into a Functional ``task`` (transparent region)."""
    ops = list(ops)
    return Op(name=name or fresh_name("task"), kind="task", region=ops)


def make_dispatch(tasks: Sequence[Op], name: str | None = None) -> Op:
    return Op(name=name or fresh_name("dispatch"), kind="dispatch",
              region=list(tasks))


# --------------------------------------------------------------------------
# Graph: a module holding values + a top-level region
# --------------------------------------------------------------------------

@dataclass
class GraphTopology:
    """Value/hierarchy topology of a :class:`Graph` — the Functional-level
    analogue of :class:`ScheduleTopology`, and the analysis substrate of
    the pre-lowering passes (task fusion above all).

    Holds the value→op indices (which leaf ops produce / consume each
    tensor, in pre-order walk position), the task/dispatch hierarchy
    (parent map), and lazily-memoized per-op rollups (transitive
    produces/consumes sets, steady-state intensity, leaf-kind summaries
    for pattern matching).  Everything depends only on the graph's
    *structure* (op identities, region nesting, ins/outs, flops), so the
    instance is cached on the graph (:meth:`Graph.topology`) against a
    structure signature and survives until a pass restructures the
    region tree.

    Ops are keyed by ``id()``; every keyed op is pinned in ``_pins`` so
    the ids stay unique for the topology's lifetime.  Mutation flows
    exclusively through :class:`repro_torch.core.rewrite.GraphRewriteSession`,
    which maintains the indices in O(Δ) per rewrite and installs the
    updated topology at commit."""

    #: value name -> leaf ops producing / consuming it, in walk order
    producers: dict[str, list[Op]]
    consumers: dict[str, list[Op]]
    #: id(op) -> enclosing region op (None for top-level ops)
    parent: dict[int, Optional[Op]]
    #: structure fingerprint this topology was built against
    signature: tuple
    # Lazy rollup memos (id-keyed; ops pinned below).  Merged tasks get
    # their entries seeded by GraphRewriteSession.fuse in O(1) set ops.
    _produces: dict[int, frozenset] = field(default_factory=dict)
    _consumes: dict[int, frozenset] = field(default_factory=dict)
    _intensity: dict[int, float] = field(default_factory=dict)
    _leaf_meta: dict[int, tuple[Optional[str], frozenset]] = field(
        default_factory=dict)
    _pins: list = field(default_factory=list)

    def _pin(self, op: Op) -> None:
        self._pins.append(op)

    def produces(self, op: Op) -> frozenset:
        """Transitive outputs of ``op`` (region-aware), memoized."""
        s = self._produces.get(id(op))
        if s is None:
            s = frozenset(op.all_outs())
            self._produces[id(op)] = s
            self._pin(op)
        return s

    def consumes(self, op: Op) -> frozenset:
        """Transitive live-in values of ``op`` (region-aware), memoized."""
        s = self._consumes.get(id(op))
        if s is None:
            s = frozenset(op.all_ins())
            self._consumes[id(op)] = s
            self._pin(op)
        return s

    def intensity(self, op: Op) -> float:
        v = self._intensity.get(id(op))
        if v is None:
            v = op.intensity()
            self._intensity[id(op)] = v
            self._pin(op)
        return v

    def leaf_meta(self, op: Op) -> tuple[Optional[str], frozenset]:
        """``(last leaf kind, set of leaf kinds)`` — what the fusion
        patterns match on, without re-walking the region per candidate."""
        m = self._leaf_meta.get(id(op))
        if m is None:
            kinds = [o.kind for o in op.walk() if not o.has_region]
            m = (kinds[-1] if kinds else None, frozenset(kinds))
            self._leaf_meta[id(op)] = m
            self._pin(op)
        return m

    def parent_of(self, op: Op) -> Optional[Op]:
        return self.parent.get(id(op))

    def note_fusion(self, merged: Op, first: Op, second: Op) -> None:
        """Seed the rollup memos for a task fused from ``first`` +
        ``second`` (region order preserved) — O(1) set algebra instead of
        a region re-walk.  ``consumes`` excludes values ``second`` reads
        that ``first`` already produced (they became region-internal).
        Intensity is the one rollup recomputed by walking ``merged``:
        float addition is not associative, so summing the two memoized
        partials could drift an ulp from the sequential region walk and
        flip a tied least-critical fusion choice."""
        pf, ps = self.produces(first), self.produces(second)
        cf, cs = self.consumes(first), self.consumes(second)
        lf, ls = self.leaf_meta(first), self.leaf_meta(second)
        self._produces[id(merged)] = pf | ps
        self._consumes[id(merged)] = cf | (cs - pf)
        self._intensity[id(merged)] = merged.intensity()
        self._leaf_meta[id(merged)] = (ls[0] if ls[0] is not None else lf[0],
                                       lf[1] | ls[1])
        self._pin(merged)

    @classmethod
    def build(cls, graph: "Graph") -> "GraphTopology":
        producers: dict[str, list[Op]] = {}
        consumers: dict[str, list[Op]] = {}
        parent: dict[int, Optional[Op]] = {}
        pins: list = []

        def visit(op: Op, par: Optional[Op]) -> None:
            parent[id(op)] = par
            pins.append(op)
            if not op.has_region:
                for v in op.outs:
                    producers.setdefault(v, []).append(op)
                for v in op.ins:
                    consumers.setdefault(v, []).append(op)
            for c in op.region:
                visit(c, op)

        for top in graph.ops:
            visit(top, None)
        return cls(producers=producers, consumers=consumers, parent=parent,
                   signature=graph.structure_signature(), _pins=pins)


@dataclass
class Graph:
    """Top-level Functional dataflow module (transparent global context)."""

    name: str
    values: dict[str, TensorValue] = field(default_factory=dict)
    ops: list[Op] = field(default_factory=list)
    inputs: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    # Cached GraphTopology (see topology()); never compared/printed.
    _topology: Optional[GraphTopology] = field(
        default=None, repr=False, compare=False)

    # -- builder interface --------------------------------------------------
    def tensor(self, name: str, shape: Sequence[int], dtype: str = "bf16",
               dims: Sequence[str] = (), is_weight: bool = False,
               is_input: bool = False) -> TensorValue:
        if name in self.values:
            raise ValueError(f"duplicate value {name}")
        t = TensorValue(name, tuple(shape), dtype, tuple(dims), is_weight)
        self.values[name] = t
        if is_input or is_weight:
            self.inputs.append(name)
        return t

    def add(self, op: Op) -> Op:
        self.ops.append(op)
        return op

    def op(self, kind: str, ins: Sequence[str], outs: Sequence[str],
           loop_dims: dict[str, int] | None = None, flops: int = 0,
           access: dict[str, AccessMap] | None = None,
           name: str | None = None, **attrs) -> Op:
        """Create a primitive op; default access maps are identity over the
        value's logical dims restricted to this op's loop dims."""
        loop_dims = dict(loop_dims or {})
        access = dict(access or {})
        for v in list(ins) + list(outs):
            if v not in self.values:
                raise ValueError(f"unknown value {v}")
            if v not in access:
                t = self.values[v]
                access[v] = AccessMap(tuple(
                    (d if d in loop_dims else None, Fraction(1))
                    for d in t.dims))
        o = Op(name=name or fresh_name(kind), kind=kind, ins=list(ins),
               outs=list(outs), loop_dims=loop_dims, flops=flops,
               access=access, attrs=attrs)
        return self.add(o)

    # -- analysis ------------------------------------------------------------
    def walk(self, pre: bool = True) -> Iterator[Op]:
        for op in self.ops:
            yield from op.walk(pre)

    def leaf_ops(self) -> list[Op]:
        return [o for o in self.walk() if not o.has_region]

    def producers(self, value: str) -> list[Op]:
        return list(self.topology().producers.get(value, ()))

    def consumers(self, value: str) -> list[Op]:
        return list(self.topology().consumers.get(value, ()))

    def total_flops(self) -> int:
        return sum(o.flops for o in self.leaf_ops())

    # -- shared topology cache ------------------------------------------------
    def structure_signature(self) -> tuple:
        """Fingerprint of everything :class:`GraphTopology` depends on:
        op identities, region structure (a fused task changes region
        lengths), value ins/outs, and the intensity inputs (flops,
        repeat)."""
        return tuple(
            (o.name, o.kind, len(o.region), tuple(o.ins), tuple(o.outs),
             o.flops, o.repeat)
            for o in self.walk())

    def topology(self) -> GraphTopology:
        """The cached :class:`GraphTopology`, rebuilt transparently when
        the structure signature no longer matches (sessionless external
        surgery; the pass pipeline itself — construction included —
        commits maintained topologies, so its boundaries are cache
        hits)."""
        if (self._topology is None
                or self._topology.signature != self.structure_signature()):
            self._topology = GraphTopology.build(self)
        return self._topology

    def invalidate_topology(self) -> None:
        self._topology = None


# --------------------------------------------------------------------------
# Structural dataflow
# --------------------------------------------------------------------------

@dataclass
class Node:
    """Structural dataflow node: isolated region with explicit effects.

    ``args`` maps value name → MemoryEffect.  The body is the list of leaf
    ops that were fused into this node (kept for intensity / access-map
    queries during parallelization).  ``params`` mirrors the paper's
    constant-parameter list (compile-time attributes).
    """

    name: str
    args: dict[str, str] = field(default_factory=dict)
    body: list[Op] = field(default_factory=list)
    params: dict = field(default_factory=dict)
    # Filled by the parallelizer: loop dim -> sharding factor, and
    # loop dim -> mesh axes tuple.
    unroll: dict[str, int] = field(default_factory=dict)
    axis_map: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # Filled by balance/schedule passes.
    stage: int = 0
    sub_schedule: Optional["Schedule"] = None

    def intensity(self) -> float:
        return sum(o.intensity() for o in self.body)

    @property
    def repeat(self) -> float:
        return max((o.repeat for o in self.body), default=1.0)

    def loop_dims(self) -> dict[str, int]:
        dims: dict[str, int] = {}
        for o in self.body:
            for d, n in o.loop_dims.items():
                dims[d] = max(dims.get(d, 0), n)
        return dims

    def reads(self) -> list[str]:
        return [v for v, e in self.args.items()
                if e in (MemoryEffect.READ, MemoryEffect.READ_WRITE)]

    def writes(self) -> list[str]:
        return [v for v, e in self.args.items()
                if e in (MemoryEffect.WRITE, MemoryEffect.READ_WRITE)]

    def access_for(self, value: str) -> Optional[AccessMap]:
        """Merged access map for ``value`` across body ops.

        Per tensor axis, the entry of the *earliest* body op whose map
        names a loop dim at that axis wins; axes no body op indexes stay
        ``(None, stride-of-first-map)``.  A node fused from several ops
        can touch the same buffer with complementary maps (e.g. a copy
        indexing axis 0 and a compute op indexing axis 1) — returning the
        first op's map wholesale would hide every later op's dims from
        plan projection and the connection analysis (the same first-owner
        hazard class ``project_rules`` had across *nodes*)."""
        maps = [o.access[value] for o in self.body if value in o.access]
        if not maps:
            return None
        first = maps[0]
        if len(maps) == 1:
            return first
        rank = max(len(m.entries) for m in maps)
        entries = []
        for axis in range(rank):
            chosen = None
            for m in maps:
                if axis < len(m.entries) and m.entries[axis][0] is not None:
                    chosen = m.entries[axis]
                    break
            if chosen is None:
                chosen = (first.entries[axis] if axis < len(first.entries)
                          else (None, Fraction(1)))
            entries.append(chosen)
        merged = tuple(entries)
        return first if merged == first.entries else AccessMap(merged)


def topo_order_over(nodes: Sequence["Node"],
                    edges: Iterable[tuple[str, str, str]],
                    name: str = "") -> list["Node"]:
    """Stable topological order of ``nodes`` over ``edges`` — the shared
    walk behind :meth:`Schedule.topo_order` and the rewrite session's
    in-flight queries (which run it over Δ-maintained edges instead of
    rebuilding the schedule topology).

    O(V + E log E): a name→node map and per-node successor lists sorted
    by node position replace the former all-nodes rescan per pop, while
    visiting successors in exactly the node-list order the rescan did —
    the emitted order is unchanged."""
    by_name = {n.name: n for n in nodes}
    pos = {n.name: i for i, n in enumerate(nodes)}
    succ: dict[str, set[str]] = {n.name: set() for n in nodes}
    indeg: dict[str, int] = {n.name: 0 for n in nodes}
    for s, d, _ in edges:
        if d not in succ[s]:
            succ[s].add(d)
            indeg[d] += 1
    order: list[Node] = []
    ready = deque(n for n in nodes if indeg[n.name] == 0)
    while ready:
        n = ready.popleft()
        order.append(n)
        for m in sorted(succ[n.name], key=pos.__getitem__):
            indeg[m] -= 1
            if indeg[m] == 0:
                ready.append(by_name[m])
    if len(order) != len(nodes):
        raise ValueError(f"schedule {name} has a dataflow cycle")
    return order


def depth_map_over(nodes: Sequence["Node"],
                   edges: Iterable[tuple[str, str, str]],
                   name: str = "") -> dict[str, int]:
    """Longest-path depth per node over ``edges`` (see
    :func:`topo_order_over`)."""
    edges = list(edges)
    depth = {n.name: 0 for n in nodes}
    succ: dict[str, list[str]] = {n.name: [] for n in nodes}
    for s, d, _ in edges:
        succ[s].append(d)
    for n in topo_order_over(nodes, edges, name):
        for d in succ[n.name]:
            depth[d] = max(depth[d], depth[n.name] + 1)
    return depth


@dataclass
class TokenEdge:
    """Elastic token-flow edge (Section 6.4.2): ``src`` must complete an
    iteration before ``dst`` may start; realised on TPU as a data dependency
    or an ``optimization_barrier`` for host-offload DMA ordering."""

    src: str
    dst: str


@dataclass
class ScheduleTopology:
    """Edge/access topology of a :class:`Schedule` — the shared analysis
    substrate of the QoR estimator and the plan-projection engine.

    Everything here depends only on the schedule's *structure* (nodes,
    args, buffers, body-op access maps), never on the parallelization
    state (``unroll`` / ``axis_map``), so one build serves the whole
    optimize() pipeline from the DSE through plan derivation and the
    incremental EP-widening re-projection.  Obtain it through
    :meth:`Schedule.topology`, which caches it against a structure
    signature and rebuilds transparently after structural mutation
    (multi-producer elimination, balancing copies, …).
    """

    #: per buffer: producing / consuming nodes, in node order (matching
    #: ``Schedule.producers_of`` / ``consumers_of``)
    producers: dict[str, list[Node]]
    consumers: dict[str, list[Node]]
    #: (src_node, dst_node, buffer) shared-buffer edges (``Schedule.edges``)
    edges: list[tuple[str, str, str]]
    #: per buffer axis: the (owner node, loop dim) pairs with a non-None
    #: access-map entry at that axis, in owner (producers + consumers) order
    axis_owner_dims: dict[str, tuple[tuple[tuple[Node, str], ...], ...]]
    #: per buffer axis: the coherent projection dim — the first non-None
    #: loop dim any owner's access map names at that axis (None if none)
    axis_dims: dict[str, tuple[Optional[str], ...]]
    #: loop dim -> buffers whose coherent projection references it
    buffers_of_dim: dict[str, tuple[str, ...]]
    #: (node name, value name) -> merged access map (``Node.access_for``)
    _access: dict[tuple[str, str], Optional[AccessMap]]
    #: structure fingerprint this topology was built against
    signature: tuple
    #: lazily memoized topo order / longest-path depth map.  Safe to cache
    #: here: the topology object itself is rebuilt (via the signature check
    #: in ``Schedule.topology``) whenever the structure changes, so these
    #: can never go stale independently of the object that owns them.
    _order_memo: Optional[list[Node]] = field(
        default=None, repr=False, compare=False)
    _depth_memo: Optional[dict[str, int]] = field(
        default=None, repr=False, compare=False)

    def topo_order(self, nodes: list[Node], name: str) -> list[Node]:
        """Memoized ``topo_order_over`` — the walk runs once per topology
        build, then every caller gets a fresh list copy."""
        if self._order_memo is None:
            self._order_memo = topo_order_over(nodes, self.edges, name)
        return list(self._order_memo)

    def depth_of(self, nodes: list[Node], name: str) -> dict[str, int]:
        """Memoized ``depth_map_over`` — one relaxation pass per topology
        build, fresh dict copies out."""
        if self._depth_memo is None:
            self._depth_memo = depth_map_over(nodes, self.edges, name)
        return dict(self._depth_memo)

    def access_for(self, node: Node, value: str) -> Optional[AccessMap]:
        """Cached ``node.access_for(value)``."""
        key = (node.name, value)
        if key not in self._access:
            self._access[key] = node.access_for(value)
        return self._access[key]

    def owners(self, buf: str) -> list[Node]:
        """Producers then consumers — the scan order of plan projection."""
        return self.producers.get(buf, []) + self.consumers.get(buf, [])

    @classmethod
    def build(cls, sched: "Schedule") -> "ScheduleTopology":
        producers: dict[str, list[Node]] = {}
        consumers: dict[str, list[Node]] = {}
        for n in sched.nodes:
            for b in n.writes():
                producers.setdefault(b, []).append(n)
            for b in n.reads():
                consumers.setdefault(b, []).append(n)
        edges = []
        for buf in sched.buffers:
            for p in producers.get(buf, ()):
                for c in consumers.get(buf, ()):
                    if p.name != c.name:
                        edges.append((p.name, c.name, buf))
        access: dict[tuple[str, str], Optional[AccessMap]] = {}
        axis_owner_dims: dict[str, tuple] = {}
        axis_dims: dict[str, tuple] = {}
        buffers_of_dim: dict[str, list[str]] = {}
        for bname, buf in sched.buffers.items():
            owners = producers.get(bname, []) + consumers.get(bname, [])
            per_axis: list[tuple[tuple[Node, str], ...]] = []
            dims: list[Optional[str]] = []
            for axis in range(len(buf.shape)):
                pairs = []
                for node in owners:
                    key = (node.name, bname)
                    if key not in access:
                        access[key] = node.access_for(bname)
                    am = access[key]
                    if am is None or axis >= len(am.entries):
                        continue
                    d = am.entries[axis][0]
                    if d is not None:
                        pairs.append((node, d))
                per_axis.append(tuple(pairs))
                dims.append(pairs[0][1] if pairs else None)
            axis_owner_dims[bname] = tuple(per_axis)
            axis_dims[bname] = tuple(dims)
            for d in dims:
                if d is not None and (d not in buffers_of_dim
                                      or buffers_of_dim[d][-1] != bname):
                    buffers_of_dim.setdefault(d, []).append(bname)
        return cls(
            producers=producers, consumers=consumers, edges=edges,
            axis_owner_dims=axis_owner_dims, axis_dims=axis_dims,
            buffers_of_dim={d: tuple(v) for d, v in buffers_of_dim.items()},
            _access=access, signature=sched.structure_signature())


def topology_index_bytes(topo: ScheduleTopology) -> int:
    """Logical footprint of a :class:`ScheduleTopology`'s caches, in bytes.

    Counts 8 bytes (one machine word) per stored reference/entry across
    the edge list, the per-buffer producer/consumer lists, the per-axis
    owner tables, the access-map memo and the order/depth memos.  This is
    a *representation-comparable* measure (like ``region_index_bytes`` in
    ``core.rewrite``), not an exact ``sys.getsizeof`` sum — it is what the
    ``bench_compile_time`` memory gate tracks so a regression in cache
    growth shows up as a number, independent of CPython object overhead.
    """
    total = 8 * 3 * len(topo.edges)
    for m in (topo.producers, topo.consumers):
        total += sum(8 * (1 + len(v)) for v in m.values())
    for per_axis in topo.axis_owner_dims.values():
        total += sum(8 * 2 * len(pairs) for pairs in per_axis)
    total += sum(8 * (1 + len(v)) for v in topo.axis_dims.values())
    total += sum(8 * (1 + len(v)) for v in topo.buffers_of_dim.values())
    total += 8 * 2 * len(topo._access)
    if topo._order_memo is not None:
        total += 8 * len(topo._order_memo)
    if topo._depth_memo is not None:
        total += 8 * 2 * len(topo._depth_memo)
    return total


@dataclass
class Schedule:
    """Structural dataflow schedule: isolated region of nodes + buffers."""

    name: str
    nodes: list[Node] = field(default_factory=list)
    buffers: dict[str, Buffer] = field(default_factory=dict)
    streams: dict[str, Stream] = field(default_factory=dict)
    # Values passed in from the enclosing context (external buffers).
    args: list[str] = field(default_factory=list)
    outputs: list[str] = field(default_factory=list)
    tokens: list[TokenEdge] = field(default_factory=list)
    # Byte size of every value (incl. node-internal temporaries) — used by
    # the estimator for intra-node reduction-collective costs.
    value_bytes: dict[str, int] = field(default_factory=dict)
    # Cached ScheduleTopology (see topology()); never compared/printed.
    _topology: Optional[ScheduleTopology] = field(
        default=None, repr=False, compare=False)
    # Lazy name→Node map behind node(); validated by list length (nodes
    # are only ever inserted, never replaced in place) and by re-checking
    # the hit's name (in-place renames).  Never compared/printed.
    _node_cache: Optional[dict] = field(
        default=None, repr=False, compare=False)
    _node_cache_len: int = field(default=-1, repr=False, compare=False)

    def node(self, name: str) -> Node:
        """Look up a node by name — O(1) amortized via a lazily rebuilt
        dict (the former linear scan was O(n²) aggregate at 1k+ nodes)."""
        cache = self._node_cache
        if cache is None or self._node_cache_len != len(self.nodes):
            cache = {n.name: n for n in self.nodes}
            self._node_cache = cache
            self._node_cache_len = len(self.nodes)
        hit = cache.get(name)
        if hit is None or hit.name != name:
            cache = {n.name: n for n in self.nodes}
            self._node_cache = cache
            self._node_cache_len = len(self.nodes)
            hit = cache.get(name)
            if hit is None:
                raise KeyError(name)
        return hit

    # -- shared topology cache ------------------------------------------------
    def structure_signature(self) -> tuple:
        """Cheap fingerprint of everything :class:`ScheduleTopology` depends
        on: node identities, their argument effects and body sizes (access
        maps live in body ops; structural passes that rewire them always
        rename args or insert ops too), buffer shapes/dims (axis_dims is
        per buffer axis), and the buffer/arg sets.  The parallelization
        state (``unroll`` / ``axis_map``) is deliberately excluded —
        topology is assignment-independent."""
        return (
            tuple((n.name, tuple(n.args.items()), len(n.body))
                  for n in self.nodes),
            tuple((b, buf.shape, buf.dims)
                  for b, buf in self.buffers.items()),
            tuple(self.args))

    def topology(self) -> ScheduleTopology:
        """The cached :class:`ScheduleTopology`, rebuilt transparently when
        the structure signature no longer matches (e.g. after
        multi-producer elimination or balancing inserted nodes)."""
        if (self._topology is None
                or self._topology.signature != self.structure_signature()):
            self._topology = ScheduleTopology.build(self)
        return self._topology

    def invalidate_topology(self) -> None:
        self._topology = None

    def is_internal(self, buf: str) -> bool:
        """A buffer allocated inside this schedule (not an argument).

        Internal buffers admit the duplication transform of Alg. 3 case (1);
        external buffers require producer fusion (case 2)."""
        return buf in self.buffers and buf not in self.args

    def producers_of(self, buf: str) -> list[Node]:
        """Nodes writing ``buf``, in node order (topology-served)."""
        return list(self.topology().producers.get(buf, ()))

    def consumers_of(self, buf: str) -> list[Node]:
        """Nodes reading ``buf``, in node order (topology-served)."""
        return list(self.topology().consumers.get(buf, ()))

    def internal_buffers(self) -> list[str]:
        return [b for b in self.buffers if self.is_internal(b)]

    def external_buffers(self) -> list[str]:
        return [b for b in self.args if b in self.buffers]

    # -- DAG helpers ---------------------------------------------------------
    def edges(self) -> list[tuple[str, str, str]]:
        """(src_node, dst_node, buffer) edges via shared buffers.

        Served from the cached :class:`ScheduleTopology` (one pass over
        the nodes builds the per-buffer producer/consumer lists in node
        order, matching ``producers_of``/``consumers_of``)."""
        return list(self.topology().edges)

    def happens_before_edges(self) -> list[tuple[str, str, str]]:
        """Dataflow edges plus token edges (buffer slot ``"<token>"``) —
        the happens-before relation the static hazard analyzer
        (:mod:`repro_torch.core.analyze`) walks for write-ordering and cycle
        checks.  Token edges are ordering-only (Section 6.4.2), so they
        extend reachability without adding data traffic."""
        return self.edges() + [(t.src, t.dst, "<token>")
                               for t in self.tokens]

    def topo_order(self) -> list[Node]:
        """Topological order over buffer edges (stable; raises on cycles
        between distinct nodes, ignoring self-loops from RW args).

        Memoized on the cached topology: repeated calls between structural
        mutations cost one list copy, not a fresh Kahn walk — the balance
        and stage-assignment passes call this per candidate at scale."""
        return self.topology().topo_order(self.nodes, self.name)

    def depth_of(self) -> dict[str, int]:
        """Longest-path depth per node (for data-path balancing).

        Memoized on the cached topology (same contract as
        :meth:`topo_order`)."""
        return self.topology().depth_of(self.nodes, self.name)

    # -- serialisation --------------------------------------------------------
    def to_dict(self) -> dict:
        """Complete, deterministic structural dump — node order, buffer
        order, argument effects, body ops with access maps, balancing
        tokens and parallelization state all included.  Two schedules are
        structurally identical iff their dicts (and hence ``to_json``
        strings) are equal; the golden-invariance sweep in
        ``tests/test_rewrite.py`` pins the whole pre-DSE pipeline on it."""
        def am(m: AccessMap) -> list:
            return [[d, str(s)] for d, s in m.entries]

        def op_d(o: Op) -> dict:
            return {
                "name": o.name, "kind": o.kind, "ins": list(o.ins),
                "outs": list(o.outs), "loop_dims": dict(o.loop_dims),
                "flops": o.flops, "repeat": o.repeat,
                "access": {v: am(m) for v, m in o.access.items()},
                "attrs": {k: repr(v) for k, v in sorted(o.attrs.items())},
                "region": [op_d(c) for c in o.region],
            }

        def node_d(n: Node) -> dict:
            return {
                "name": n.name, "args": dict(n.args), "stage": n.stage,
                "params": {k: repr(v) for k, v in sorted(n.params.items())},
                "unroll": dict(n.unroll),
                "axis_map": {d: list(a) for d, a in n.axis_map.items()},
                "body": [op_d(o) for o in n.body],
                "sub_schedule": (n.sub_schedule.to_dict()
                                 if n.sub_schedule is not None else None),
            }

        def buf_d(b: Buffer) -> dict:
            return {
                "name": b.name, "shape": list(b.shape), "dtype": b.dtype,
                "dims": list(b.dims), "stages": b.stages,
                "partition": [[k, f] for k, f in b.partition],
                "tiling": list(b.tiling), "placement": b.placement,
                "is_weight": b.is_weight,
                "spec": ([list(a) for a in b.spec]
                         if b.spec is not None else None),
            }

        return {
            "name": self.name,
            "args": list(self.args),
            "outputs": list(self.outputs),
            "nodes": [node_d(n) for n in self.nodes],
            "buffers": {b: buf_d(buf) for b, buf in self.buffers.items()},
            "streams": {s: {"name": st.name,
                            "elem_shape": list(st.elem_shape),
                            "dtype": st.dtype, "entries": st.entries,
                            "is_token": st.is_token}
                        for s, st in self.streams.items()},
            "tokens": [[t.src, t.dst] for t in self.tokens],
            "value_bytes": dict(self.value_bytes),
        }

    def to_json(self) -> str:
        import json
        return json.dumps(self.to_dict(), indent=1)
