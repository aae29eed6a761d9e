"""Functional dataflow construction — paper Algorithm 1.

Walk regions bottom-up; every *dispatchable* region (owned by an iterative
op — here: the module or a composite block — and containing at least two
iterative sub-ops) is wrapped in a ``dispatch`` whose children each become a
``task``.  The result is the hierarchical Functional dataflow of Fig. 3.

The pass runs inside a :class:`~repro_torch.core.rewrite.GraphRewriteSession`
(one :meth:`~repro_torch.core.rewrite.GraphRewriteSession.wrap_dispatch` per
dispatchable region), which makes the *entry* pass transactional like
every later one — an exception leaves the graph untouched — and commits
a maintained topology, so ``fuse_tasks`` starts on a warm cache instead
of paying a full rebuild at the construct/fuse boundary.  Wrapping never
touches leaf ops, so the value→op indices carry over verbatim; only the
parent map grows.
"""
from __future__ import annotations

from .faults import fault_point
from .ir import Graph, Op
from .rewrite import GraphRewriteSession

#: op kinds considered "iterative" (own a loop nest / region) — paper: an op
#: is iterative if it is a loop or a func.  For the tensor graphs we trace,
#: every compute op carries a loop nest, while bookkeeping ops do not.
_NON_ITERATIVE = {"const", "reshape_view", "token"}


def is_iterative(op: Op) -> bool:
    return op.has_region or (op.kind not in _NON_ITERATIVE
                             and bool(op.loop_dims))


def is_dispatchable(ops: list[Op]) -> bool:
    """A region is dispatchable when ≥2 of its ops are iterative."""
    return sum(1 for o in ops if is_iterative(o)) >= 2


def _construct_region(rs: GraphRewriteSession, owner: Op | None,
                      ops: list[Op]) -> None:
    # Bottom-up: recurse into nested regions first (post-order walk).
    for o in ops:
        if o.has_region:
            _construct_region(rs, o, o.region)
    if is_dispatchable(ops):
        fault_point("construct.wrap")
        rs.wrap_dispatch(owner)


def construct_functional(graph: Graph, selfcheck: bool = False) -> Graph:
    """Paper Algorithm 1: produce the initial (maximally split) Functional
    dataflow in-place and return the graph.

    ``selfcheck`` asserts the session's maintained topology against a
    from-scratch rebuild after every wrap (tests only)."""
    with GraphRewriteSession(graph, selfcheck=selfcheck) as rs:
        _construct_region(rs, None, graph.ops)
    return graph
