"""Functional → Structural dataflow lowering — paper Section 6.3.

Three procedures:

1. *Buffer generation*: every tensor crossing a task boundary becomes a
   ``Buffer`` with default partition / tiling / placement attributes
   (tensor semantics → memory semantics, Fig. 6).
2. *dispatch → schedule* mapping.
3. *task → node* mapping: because Functional ops are transparent while
   Structural ops are isolated, live-ins and memory effects are analysed
   here and recorded explicitly on each ``Node``'s argument list.

Values produced *and* consumed entirely inside one task stay node-internal
(they never materialise as schedule buffers — on TPU they live in registers
/ VMEM inside the fused XLA computation).

The schedule is assembled through a
:class:`~repro_torch.core.rewrite.ScheduleRewriteSession` (``add_node`` /
``add_buffer`` / ``drop_arg`` / ``set_outputs``), whose commit installs
the Δ-maintained :class:`~repro_torch.core.ir.ScheduleTopology` — the
downstream passes and the DSE start on a warm topology cache instead of
paying the first full index build.
"""
from __future__ import annotations

from .faults import fault_point
from .ir import Buffer, Graph, MemoryEffect, Node, Op, Schedule
from .rewrite import ScheduleRewriteSession


def _node_effects(task: Op) -> dict[str, str]:
    """Explicit memory-effect analysis for one task (paper Fig. 4)."""
    reads: list[str] = []
    writes: list[str] = []
    produced: set[str] = set()
    for o in task.walk():
        if o.has_region:
            continue
        for v in o.ins:
            if v not in produced and v not in reads:
                reads.append(v)
        for v in o.outs:
            produced.add(v)
            if v not in writes:
                writes.append(v)
    effects: dict[str, str] = {}
    for v in reads:
        effects[v] = MemoryEffect.READ
    for v in writes:
        # A value both read and written by the task (in-place update, e.g.
        # a KV-cache slot or gradient accumulator) carries RW.
        effects[v] = (MemoryEffect.READ_WRITE if v in effects
                      else MemoryEffect.WRITE)
    return effects


def _leaf_body(task: Op) -> list[Op]:
    return [o for o in task.walk() if not o.has_region]


def fallback_schedule(graph: Graph, name: str | None = None) -> Schedule:
    """Bottom rung of the degradation ladder for lowering failures: the
    whole graph as ONE Structural node (every leaf op in one body, every
    graph input/output/weight as an external buffer).

    Always legal — no internal edges, so acyclicity, stage order and
    multi-producer invariants hold trivially — and the DSE can still
    shard the single node, so a broken lowering degrades to a fused
    whole-model computation instead of a failed compile.  Deliberately
    assembled *without* a rewrite session: this path must stay
    serviceable when the transactional machinery (or a fault injected
    into it) is what took the primary lowering down."""
    leaves = [o for top in graph.ops for o in top.walk()
              if not o.has_region]
    effects = _node_effects(Op(name="__fallback__", kind="task",
                               region=leaves))
    graph_io = set(graph.inputs) | set(graph.outputs)
    crossing = {v: e for v, e in effects.items()
                if v in graph_io or graph.values[v].is_weight}
    sched = Schedule(name=name or f"{graph.name}_sched_fallback")
    sched.nodes.append(Node(name=f"{graph.name}_all", args=dict(crossing),
                            body=leaves))
    for v in crossing:
        sched.buffers[v] = Buffer.from_tensor(graph.values[v],
                                              placement="hbm")
        sched.args.append(v)
    sched.outputs = [v for v in graph.outputs if v in sched.buffers]
    sched.value_bytes = {v: t.bytes for v, t in graph.values.items()}
    return sched


def lower_to_structural(graph: Graph, name: str | None = None,
                        selfcheck: bool = False) -> Schedule:
    """Lower the (fused) Functional dataflow to a Structural schedule.

    ``selfcheck`` asserts the session's maintained topology against a
    from-scratch build after every rewrite (tests only); it propagates
    to recursively-lowered sub-schedules."""
    # The top level is a single dispatch after construction+fusion; tolerate
    # a bare op list for tiny graphs (no dataflow opportunity).
    if len(graph.ops) == 1 and graph.ops[0].kind == "dispatch":
        tasks = graph.ops[0].region
    else:
        tasks = graph.ops

    sched = Schedule(name=name or f"{graph.name}_sched")
    with ScheduleRewriteSession(sched, selfcheck=selfcheck) as rs:
        for t in tasks:
            fault_point("lower.node")
            effects = _node_effects(t)
            sub = None
            inner_dispatches = [c for c in t.region if c.kind == "dispatch"]
            if inner_dispatches:
                # Recursive nesting: lower the inner dispatch to a
                # sub-schedule (with its own session).
                inner_graph = Graph(name=f"{t.name}_inner",
                                    values=graph.values,
                                    ops=[inner_dispatches[0]])
                sub = lower_to_structural(inner_graph, name=f"{t.name}_sub",
                                          selfcheck=selfcheck)
            rs.add_node(Node(name=t.name, args=effects, body=_leaf_body(t),
                             sub_schedule=sub))
        nodes = sched.nodes

        # -- buffer generation: values crossing node boundaries ------------
        touched_by: dict[str, set[str]] = {}
        for n in nodes:
            for v in n.args:
                touched_by.setdefault(v, set()).add(n.name)

        graph_io = set(graph.inputs) | set(graph.outputs)
        for vname, users in touched_by.items():
            crossing = len(users) > 1 or vname in graph_io
            if not crossing:
                # Node-internal temporary: drop from the node arg list.
                for n in nodes:
                    if vname in n.args:
                        rs.drop_arg(n, vname)
                continue
            fault_point("lower.buffer")
            t = graph.values[vname]
            external = vname in graph_io or t.is_weight
            rs.add_buffer(Buffer.from_tensor(t, placement="hbm"),
                          external=external)
        rs.set_outputs([v for v in graph.outputs if v in sched.buffers])
        rs.set_value_bytes({v: t.bytes for v, t in graph.values.items()})
    return sched
