"""Transactional rewrite layer: every structural mutation of the
Functional graph and the Structural schedule flows through a session.

HIDA's optimizer is hierarchical precisely because every pass — task
fusion (Alg. 2), multi-producer elimination (Alg. 3), data-path balancing
(Section 6.4.2), Functional→Structural lowering (Section 6.3) — reasons
over the *same* dataflow structure.  Before this layer, each pass kept
its own ad-hoc producer/consumer scans and mutated ``Graph`` /
``Schedule`` raw, leaving ``Schedule.topology()`` to detect the damage by
signature mismatch and re-index from scratch.  Now:

* :class:`GraphRewriteSession` wraps a :class:`~repro_torch.core.ir.Graph` and
  owns the fusion-facing view of :class:`~repro_torch.core.ir.GraphTopology`:
  per-dispatch region indices (direct successor/predecessor graphs, an
  incrementally-maintained transitive-closure reachability index, and
  program-order ranks), task rollups (produces / consumes / intensity /
  leaf kinds), adjacency / cycle queries — maintained in **O(Δ)** per
  :meth:`~GraphRewriteSession.fuse` / :meth:`~GraphRewriteSession.split`
  (one region scan plus closure-row updates for the tasks whose
  reachability actually changed — never a DFS per query, never a
  quadratic rebuild per worklist step).

* :class:`ScheduleRewriteSession` wraps a
  :class:`~repro_torch.core.ir.Schedule` and maintains the producer/consumer
  indices of :class:`~repro_torch.core.ir.ScheduleTopology` across its
  primitives (``add_node`` / ``retire_node`` / ``replace_nodes`` /
  ``rename_arg`` / ``rename_buffer`` / ``insert_copy`` / ``set_arg`` /
  ``drop_arg`` / buffer and token edits).  Derived per-buffer structures
  (axis dims, the edge list, the dim→buffer inverted index) are
  invalidated per *touched buffer* and regenerated only for those buffers
  at :meth:`~ScheduleRewriteSession.commit` — untouched buffers reuse the
  pre-session topology's entries verbatim.

Both sessions are **transactions**, mirroring
:class:`~repro_torch.core.incremental.IncrementalEstimator`'s
propose/commit/rollback:

* ``commit()`` installs the maintained topology into the owner's cache
  (``graph._topology`` / ``sched._topology``) with a fresh structure
  signature, so the next ``topology()`` call is a cache *hit* — no pass
  boundary pays a re-index.
* ``rollback()`` undoes every IR mutation (each primitive logs an exact
  inverse) and reinstates the untouched pre-session topology object.
* Used as a context manager, exit commits on success and rolls back on
  exception — a pass can never leave the IR half-rewritten.

``tests/test_rewrite.py`` property-checks the whole contract: after any
prefix of a pass's rewrite trace, the maintained topology fingerprint
equals a from-scratch ``build()``, and rollback restores the pre-session
schedule and topology bit-exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

from .faults import fault_point
from .ir import (AccessMap, Buffer, Graph, GraphTopology, MemoryEffect, Node,
                 Op, Schedule, ScheduleTopology, TokenEdge, depth_map_over,
                 fresh_name, make_dispatch, make_task, topo_order_over)


class RewriteError(RuntimeError):
    """Misuse of a rewrite session (closed session, duplicate buffer,
    canonicalized graph rolled back, …)."""


def _remove_identical(lst: list, obj) -> bool:
    """Remove ``obj`` from ``lst`` by identity (dataclass ``==`` is deep
    and could match a distinct object)."""
    for i, x in enumerate(lst):
        if x is obj:
            del lst[i]
            return True
    return False


def _index_identical(lst: list, obj) -> int:
    """``lst.index(obj)`` by identity (see :func:`_remove_identical`)."""
    for i, x in enumerate(lst):
        if x is obj:
            return i
    raise ValueError(f"{getattr(obj, 'name', obj)!r} not in list")


def make_copy_op(buf: Buffer, src: str, dst: str) -> Op:
    """An explicit memory copy over the buffer's full index space — the
    copy iterates every axis, so it is shardable like any other node."""
    loop = {d: s for d, s in zip(buf.dims, buf.shape)}
    am = AccessMap.identity(buf.dims)
    return Op(name=fresh_name("copy"), kind="copy", ins=[src], outs=[dst],
              loop_dims=loop, access={src: am, dst: am})


# --------------------------------------------------------------------------
# Topology fingerprints (property tests + selfcheck mode)
# --------------------------------------------------------------------------

def schedule_topology_fingerprint(topo: ScheduleTopology) -> dict:
    """Name-based semantic content of a :class:`ScheduleTopology` — two
    topologies describe the same structure iff their fingerprints are
    equal (the lazy ``_access`` cache is deliberately excluded)."""
    return {
        "producers": {b: [n.name for n in v]
                      for b, v in topo.producers.items() if v},
        "consumers": {b: [n.name for n in v]
                      for b, v in topo.consumers.items() if v},
        "edges": list(topo.edges),
        "axis_owner_dims": {
            b: tuple(tuple((n.name, d) for n, d in pairs) for pairs in per)
            for b, per in topo.axis_owner_dims.items()},
        "axis_dims": dict(topo.axis_dims),
        "buffers_of_dim": dict(topo.buffers_of_dim),
        "signature": topo.signature,
    }


def graph_topology_fingerprint(topo: GraphTopology, graph: Graph) -> dict:
    """Name-based semantic content of a :class:`GraphTopology` restricted
    to ops currently reachable from ``graph`` (rollup memos are lazy
    caches and excluded; parent entries for retired ops are ignored)."""
    live = {id(o): o.name for o in graph.walk()}
    return {
        "producers": {v: [o.name for o in ops]
                      for v, ops in topo.producers.items() if ops},
        "consumers": {v: [o.name for o in ops]
                      for v, ops in topo.consumers.items() if ops},
        "parent": {name: (topo.parent.get(i).name
                          if topo.parent.get(i) is not None else None)
                   for i, name in live.items()},
        "signature": topo.signature,
    }


# --------------------------------------------------------------------------
# Functional-level session
# --------------------------------------------------------------------------

def _bits(mask: int):
    """Yield the set bit positions of ``mask`` (ascending)."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


# -- blocked closure rows ---------------------------------------------------
#
# A closure row is a sparse bitset stored as ``dict[block -> word]``: bit
# position ``p`` lives in 64-bit word ``p >> 6`` at offset ``p & 63``, and
# zero words are never stored — the dict keys *are* the per-block occupancy
# index.  Arbitrary-precision int rows pay for every bit below the highest
# set one (a task late in a 10k-task region costs ~1.2 KB per row even when
# it reaches three neighbours); blocked rows pay 8 bytes per *occupied*
# block, so band-structured closures (pipelines, MoE fan-outs) stay linear
# in the edges that exist.  Rows are immutable by convention — every helper
# returns a fresh dict — which keeps the exact-rollback contract of the int
# representation: undo logs store the previous row object, nothing aliases.

def _row_bits(row: dict[int, int]):
    """Yield the set bit positions of ``row`` (ascending)."""
    for k in sorted(row):
        w = row[k]
        base = k << 6
        while w:
            low = w & -w
            yield base + low.bit_length() - 1
            w ^= low


def _row_has(row: dict[int, int], p: int) -> bool:
    return bool(row.get(p >> 6, 0) >> (p & 63) & 1)


def _row_set(row: dict[int, int], p: int) -> dict[int, int]:
    """``row | {p}`` as a fresh row."""
    new = dict(row)
    new[p >> 6] = new.get(p >> 6, 0) | 1 << (p & 63)
    return new


def _row_or(a: dict[int, int], b: dict[int, int]) -> dict[int, int]:
    new = dict(a)
    for k, w in b.items():
        new[k] = new.get(k, 0) | w
    return new


def _row_fold(row: dict[int, int], p1: int, p2: int,
              add: dict[int, int]) -> dict[int, int]:
    """``(row & ~{p1, p2}) | add`` in one allocation — the per-row fuse
    update (kill the fused pair's bits, add the merged task's)."""
    new = dict(row)
    for p in (p1, p2):
        k = p >> 6
        w = new.get(k)
        if w is not None:
            w &= ~(1 << (p & 63))
            if w:
                new[k] = w
            else:
                del new[k]
    for k, w in add.items():
        new[k] = new.get(k, 0) | w
    return new


_ROW_EMPTY: dict[int, int] = {}


def _row_intersects(a: dict[int, int], b: dict[int, int]) -> bool:
    if len(b) < len(a):
        a, b = b, a
    return any(w & b.get(k, 0) for k, w in a.items())


def _row_count(row: dict[int, int]) -> int:
    return sum(w.bit_count() for w in row.values())


def _row_bytes(row: dict[int, int]) -> int:
    """Logical footprint: 8 bytes per occupied 64-bit block."""
    return 8 * len(row)


def _row_to_int(row: dict[int, int]) -> int:
    """Flatten a blocked row to the equivalent bitmask int (the reference
    representation the property tests compare against)."""
    mask = 0
    for k, w in row.items():
        mask |= w << (k << 6)
    return mask


def _row_from_int(mask: int) -> dict[int, int]:
    """Inverse of :func:`_row_to_int`."""
    row: dict[int, int] = {}
    k = 0
    while mask:
        w = mask & 0xFFFFFFFFFFFFFFFF
        if w:
            row[k] = w
        mask >>= 64
        k += 1
    return row


@dataclass
class _RegionIndex:
    """Maintained structure over one dispatch region's task graph.

    ``succ`` / ``pred`` are the direct dataflow edges (a task feeds
    another through some value); ``reach`` / ``rreach`` are the
    transitive closure and its inverse (every task reachable via ≥1 edge
    / every task that reaches the key) — the index behind
    :meth:`GraphRewriteSession.creates_cycle`, which becomes two bitwise
    ANDs instead of a DFS.

    Rows are **blocked bitsets** (``dict[block -> 64-bit word]``, zero
    words never stored — see the row helpers above): each task owns a
    bit position for the index's lifetime (merged tasks append new
    bits), so the per-fuse row rewrites — the dominant maintenance cost
    with set rows — are single ``(row & kill) | add`` folds over the
    *occupied* blocks only.  Dense int rows were the previous
    representation; they stay exact but pay for every bit below the
    highest set one, which at 10k tasks costs ~12 MB of closure rows and
    an O(n²) build even when the closure is band-structured.  Blocked
    rows keep both linear in the occupancy, and the rows stay immutable
    by convention (helpers return fresh dicts), so the exact-rollback
    contract is unchanged: undo logs store the previous row object,
    nothing can alias.  ``tests/test_blocked_rows.py`` pins blocked ==
    int-row == from-scratch-DFS closures on every rewrite.

    Interval/ILP-style orders were considered and rejected: they answer
    reachability in O(1) but cost O(region) relabelling per contraction,
    while closure rows cost O(changed rows · occupied blocks) and stay
    exact.

    ``rank`` is a program-order rank: it respects the region list order
    at all times (fusing assigns the merged task the lower of its
    parents' ranks — exactly where the merged task lands in the region),
    stays unique, and is *static* per task, so worklist structures keyed
    on it (the balance phase's pair heap) never need re-keying as the
    region list shifts.

    All keys are ``id(task)`` (tasks are pinned by the session for the
    index's lifetime); ``ops`` maps each live id back to its task and
    doubles as the liveness set; ``by_bit`` maps bit positions back to
    tasks (entries for fused-away tasks are stale — live rows never
    reference a dead bit, the maintenance clears them)."""

    ops: dict[int, Op]
    bit: dict[int, int]
    by_bit: list[Op]
    succ: dict[int, dict[int, int]]
    pred: dict[int, dict[int, int]]
    reach: dict[int, dict[int, int]]
    rreach: dict[int, dict[int, int]]
    rank: dict[int, int]
    #: bumped whenever reachability may have been *reduced* (the
    #: vanished-edge fuse fallback, split) — pure contraction never bumps.
    #: Worklists that cached a cycle verdict must reseed when it changes.
    epoch: int = 0

    def tasks(self, row: dict[int, int]) -> list[Op]:
        return [self.by_bit[b] for b in _row_bits(row)]


def _closure_rows(n: int, succ: list[dict[int, int]],
                  pred: list[dict[int, int]]) -> tuple[
        list[dict[int, int]], list[dict[int, int]]]:
    """Transitive closure (and inverse) of the DAG given as per-position
    blocked successor/predecessor rows — one Kahn walk plus one
    OR-per-occupied-block per edge (never touches the empty blocks a
    dense row representation would).  Falls back to per-node DFS if the
    input has a cycle (cannot happen for SSA-derived regions, but a
    query index must not infinite-loop on degenerate input)."""
    indeg = [_row_count(pred[i]) for i in range(n)]
    stack = [i for i in range(n) if indeg[i] == 0]
    order: list[int] = []
    while stack:
        i = stack.pop()
        order.append(i)
        for j in _row_bits(succ[i]):
            indeg[j] -= 1
            if indeg[j] == 0:
                stack.append(j)
    reach: list[dict[int, int]] = [{} for _ in range(n)]
    rreach: list[dict[int, int]] = [{} for _ in range(n)]
    if len(order) == n:
        for i in reversed(order):
            r: dict[int, int] = {}
            for j in _row_bits(succ[i]):
                r[j >> 6] = r.get(j >> 6, 0) | 1 << (j & 63)
                for k, w in reach[j].items():
                    r[k] = r.get(k, 0) | w
            reach[i] = r
        for i in order:
            rr: dict[int, int] = {}
            for j in _row_bits(pred[i]):
                rr[j >> 6] = rr.get(j >> 6, 0) | 1 << (j & 63)
                for k, w in rreach[j].items():
                    rr[k] = rr.get(k, 0) | w
            rreach[i] = rr
    else:
        for i in range(n):
            seen: set[int] = set()
            work = list(_row_bits(succ[i]))
            while work:
                j = work.pop()
                if j in seen:
                    continue
                seen.add(j)
                work.extend(_row_bits(succ[j]))
            seen.discard(i)
            row: dict[int, int] = {}
            for j in seen:
                row[j >> 6] = row.get(j >> 6, 0) | 1 << (j & 63)
            reach[i] = row
        for i in range(n):
            for j in _row_bits(reach[i]):
                rw = rreach[j]
                rw[i >> 6] = rw.get(i >> 6, 0) | 1 << (i & 63)
    return reach, rreach


def _closure_rows_int(n: int, succ: list[int], pred: list[int]) -> tuple[
        list[int], list[int]]:
    """Reference transitive closure over dense int bitmask rows — the
    previous representation, kept as the differential oracle the blocked
    closure is property-tested against (``tests/test_blocked_rows.py``
    asserts blocked == int on every rewrite of a random-DAG sweep)."""
    indeg = [pred[i].bit_count() for i in range(n)]
    stack = [i for i in range(n) if indeg[i] == 0]
    order: list[int] = []
    while stack:
        i = stack.pop()
        order.append(i)
        for j in _bits(succ[i]):
            indeg[j] -= 1
            if indeg[j] == 0:
                stack.append(j)
    reach = [0] * n
    rreach = [0] * n
    if len(order) == n:
        for i in reversed(order):
            r = 0
            for j in _bits(succ[i]):
                r |= (1 << j) | reach[j]
            reach[i] = r
        for i in order:
            rr = 0
            for j in _bits(pred[i]):
                rr |= (1 << j) | rreach[j]
            rreach[i] = rr
    else:
        for i in range(n):
            seen = 0
            work = succ[i]
            while work:
                low = work & -work
                j = low.bit_length() - 1
                work ^= low
                if not seen >> j & 1:
                    seen |= low
                    work |= succ[j] & ~seen
            reach[i] = seen & ~(1 << i)
        for i in range(n):
            for j in _bits(reach[i]):
                rreach[j] |= 1 << i
    return reach, rreach


def _build_region_index(topo: GraphTopology, d: Op) -> _RegionIndex:
    """From-scratch index for dispatch ``d`` — built once per dispatch,
    then maintained across fuses.  Direct edges come from an inverted
    value→consumers map (O(region + edges), identical edge set to the
    former all-pairs ``produces(i) & consumes(j)`` scan, which was the
    O(region²) wall at 5k+ tasks), and the closure build touches only
    occupied blocks."""
    region = list(d.region)
    n = len(region)
    succ: list[dict[int, int]] = [{} for _ in range(n)]
    pred: list[dict[int, int]] = [{} for _ in range(n)]
    cons_at: dict[str, list[int]] = {}
    for j, t in enumerate(region):
        for v in topo.consumes(t):
            cons_at.setdefault(v, []).append(j)
    for i, t in enumerate(region):
        row = succ[i]
        for v in topo.produces(t):
            for j in cons_at.get(v, ()):
                if j != i:
                    row[j >> 6] = row.get(j >> 6, 0) | 1 << (j & 63)
                    pr = pred[j]
                    pr[i >> 6] = pr.get(i >> 6, 0) | 1 << (i & 63)
    reach, rreach = _closure_rows(n, succ, pred)
    ids = [id(t) for t in region]
    return _RegionIndex(
        ops=dict(zip(ids, region)),
        bit=dict(zip(ids, range(n))),
        by_bit=list(region),
        succ=dict(zip(ids, succ)), pred=dict(zip(ids, pred)),
        reach=dict(zip(ids, reach)), rreach=dict(zip(ids, rreach)),
        rank=dict(zip(ids, range(n))))


def region_index_bytes(idx: _RegionIndex) -> int:
    """Logical byte footprint of a region index: 8 bytes per occupied
    64-bit closure-row block across all four row families, plus one word
    per rank/bit entry.  This counts the information the index holds —
    not CPython dict overhead — so it is comparable across
    representations and is what the bench memory gate tracks."""
    total = 0
    for table in (idx.succ, idx.pred, idx.reach, idx.rreach):
        for row in table.values():
            total += _row_bytes(row)
    return total + 8 * (len(idx.rank) + len(idx.bit))


def region_index_fingerprint(idx: _RegionIndex) -> dict:
    """Name-based content of a :class:`_RegionIndex` (exact-rollback
    tests compare these across a mutate → rollback round trip)."""
    def rows(d: dict[int, int]) -> dict:
        return {idx.ops[k].name: frozenset(t.name for t in idx.tasks(v))
                for k, v in d.items()}

    return {"succ": rows(idx.succ), "pred": rows(idx.pred),
            "reach": rows(idx.reach), "rreach": rows(idx.rreach),
            "rank": {idx.ops[k].name: r for k, r in idx.rank.items()},
            "bits": {idx.ops[k].name: b for k, b in idx.bit.items()}}


class GraphRewriteSession:
    """Transactional rewrites over a Functional :class:`Graph`.

    The construction pass (Alg. 1) and the fusion pass (Alg. 2) drive
    their whole worklists through this: adjacency and cycle queries run
    against a per-dispatch :class:`_RegionIndex` (direct edges + an
    incrementally-maintained transitive-closure reachability index) that
    is built once per dispatch and then **maintained** across
    :meth:`fuse` calls — ``creates_cycle`` is two C-level set
    intersections, never a DFS — and rollups are served from the shared
    :class:`GraphTopology` memos."""

    def __init__(self, graph: Graph, selfcheck: bool = False):
        self.graph = graph
        self._base = graph.topology()
        self._parent = dict(self._base.parent)
        #: id(dispatch) -> maintained region index
        self._regions: dict[int, _RegionIndex] = {}
        self._pins: list[Op] = []
        self._undo: list[Callable[[], None]] = []
        self._canonicalized = False
        self._open = True
        self._selfcheck = selfcheck
        #: peak logical footprint of the maintained region indices
        #: (:func:`region_index_bytes` summed over live dispatches),
        #: sampled at every index build and at commit — surfaced through
        #: ``FusionStats.index_peak_bytes`` into the bench memory gate.
        self.index_peak_bytes = 0

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "GraphRewriteSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._open:
            return
        if exc_type is None:
            try:
                self.commit()
            except BaseException:
                # A commit-time failure must not leave a half-mutated
                # graph behind: the undo log is still intact, replay it.
                if self._open:
                    self.rollback()
                raise
        else:
            self.rollback()

    def _check_open(self) -> None:
        if not self._open:
            raise RewriteError("graph rewrite session is closed")

    def commit(self) -> Optional[GraphTopology]:
        """Install the maintained topology on the graph and close the
        session.  After :meth:`canonicalize` the region tree was
        restructured wholesale, so the cache is invalidated instead (the
        next ``graph.topology()`` rebuilds lazily)."""
        self._check_open()
        fault_point("rewrite.commit")
        self._sample_index_bytes()
        self._open = False
        g = self.graph
        if self._canonicalized:
            g._topology = None
            return None
        sig = g.structure_signature()
        base = self._base
        # Ops created mid-session (merged/wrapper tasks) join the pin
        # list even when a later rewrite removed them from the tree:
        # their ids key _parent entries, and a recycled id would alias a
        # stale parent onto a future op.
        base._pins.extend(self._pins)
        if sig == base.signature:
            g._topology = base
            return base
        topo = GraphTopology(
            # Fusion only regroups tasks; the leaf ops — and hence the
            # value→op indices — are untouched and shared with the base.
            producers=base.producers, consumers=base.consumers,
            parent=self._parent, signature=sig,
            _produces=base._produces, _consumes=base._consumes,
            _intensity=base._intensity, _leaf_meta=base._leaf_meta,
            _pins=base._pins)
        g._topology = topo
        return topo

    def rollback(self) -> None:
        """Undo every rewrite (exact inverses, reverse order) and
        reinstate the untouched pre-session topology.  The lazy rollup
        memos are dropped wholesale: any entry recomputed *mid-session*
        (a selfcheck, or an ancestor query after `_invalidate_ancestors`)
        was computed against the mutated tree and must not survive into
        the restored one — they rebuild lazily against the rolled-back
        structure on next query."""
        self._check_open()
        self._open = False
        for undo in reversed(self._undo):
            undo()
        if self._undo:
            base = self._base
            base._produces.clear()
            base._consumes.clear()
            base._intensity.clear()
            base._leaf_meta.clear()
        self.graph._topology = self._base

    # -- queries ------------------------------------------------------------
    def produces(self, t: Op) -> frozenset:
        return self._base.produces(t)

    def consumes(self, t: Op) -> frozenset:
        return self._base.consumes(t)

    def intensity(self, t: Op) -> float:
        return self._base.intensity(t)

    def leaf_meta(self, t: Op) -> tuple[Optional[str], frozenset]:
        return self._base.leaf_meta(t)

    def _ensure_region(self, d: Op) -> _RegionIndex:
        if self._canonicalized:
            raise RewriteError(
                "region queries are invalid after canonicalize() — the "
                "maintained indices no longer describe the tree")
        idx = self._regions.get(id(d))
        if idx is None:
            idx = _build_region_index(self._base, d)
            self._regions[id(d)] = idx
            self._pins.extend(d.region)
            self._pins.append(d)
            self._sample_index_bytes()
        return idx

    def _sample_index_bytes(self) -> None:
        total = sum(region_index_bytes(i) for i in self._regions.values())
        if total > self.index_peak_bytes:
            self.index_peak_bytes = total

    def adjacent(self, d: Op, a: Op, b: Op) -> bool:
        """True when a feeds b or b feeds a through any value."""
        idx = self._ensure_region(d)
        return (_row_has(idx.succ[id(a)], idx.bit[id(b)])
                or _row_has(idx.succ[id(b)], idx.bit[id(a)]))

    def adjacent_pairs(self, d: Op) -> list[tuple[Op, Op]]:
        """Every adjacent task pair of dispatch ``d``, one entry per
        unordered pair (the region graph is a DAG, so each pair has at
        most one direct edge) — the balance phase's seed worklist,
        enumerated in O(edges)."""
        idx = self._ensure_region(d)
        return [(idx.ops[sid], t)
                for sid, row in idx.succ.items() for t in idx.tasks(row)]

    def neighbors(self, d: Op, t: Op) -> list[Op]:
        """Tasks adjacent to ``t`` (either direction), deduplicated."""
        idx = self._ensure_region(d)
        tid = id(t)
        return idx.tasks(_row_or(idx.succ[tid], idx.pred[tid]))

    def neighbors_in_order(self, d: Op, t: Op) -> list[Op]:
        """:meth:`neighbors` sorted by region program order — what a
        candidate scan over ``d.region`` would visit, without the
        O(region) walk."""
        idx = self._ensure_region(d)
        tid = id(t)
        out = idx.tasks(_row_or(idx.succ[tid], idx.pred[tid]))
        out.sort(key=lambda u: idx.rank[id(u)])
        return out

    def alive(self, d: Op, t: Op) -> bool:
        """True while ``t`` is a live task of dispatch ``d`` (not yet
        fused away) — O(1), for lazily-invalidated worklist entries."""
        return id(t) in self._ensure_region(d).ops

    def region_epoch(self, d: Op) -> int:
        """Bumped whenever ``d``'s reachability may have been *reduced*
        (the vanished-edge fuse fallback, :meth:`split`); unchanged by
        pure contraction.  A worklist that permanently discarded a
        cycle-creating pair (legal under contraction, where paths only
        ever appear) must reseed when this changes."""
        return self._ensure_region(d).epoch

    def rank(self, d: Op, t: Op) -> int:
        """Program-order rank of ``t`` in ``d``'s region: respects the
        region list order at all times and is static per task (a merged
        task inherits the lower parent rank — its region position), so
        heap keys built from it never go stale."""
        return self._ensure_region(d).rank[id(t)]

    def order(self, d: Op, a: Op, b: Op) -> tuple[Op, Op]:
        """``(a, b)`` sorted by region program order (rank-served — the
        O(region) ``list.index`` scan the passes used to pay)."""
        idx = self._ensure_region(d)
        return (a, b) if idx.rank[id(a)] <= idx.rank[id(b)] else (b, a)

    def creates_cycle(self, d: Op, a: Op, b: Op) -> bool:
        """Fusing a and b is illegal when a third task sits on a dataflow
        path between them (the merged task would both feed and consume
        it).  This matters for decode graphs: qkv → cache-update →
        attention must not fuse qkv with attention around the
        cache-update node.

        Served by the maintained reachability index: a third task sits
        between a and b iff ``reach(a) ∩ rreach(b)`` (or the mirror) is
        non-empty — two bitwise ANDs, no DFS.  While both tasks live the
        status is monotone *under pure contraction* (fusing other pairs
        only adds paths), so a ``True`` answer may be cached as long as
        :meth:`region_epoch` is unchanged; the vanished-edge fallback and
        :meth:`split` can remove paths and bump the epoch."""
        idx = self._ensure_region(d)
        ia, ib = id(a), id(b)
        return (_row_intersects(idx.reach[ia], idx.rreach[ib])
                or _row_intersects(idx.reach[ib], idx.rreach[ia]))

    def _invalidate_ancestors(self, d: Op) -> None:
        """Drop the rollup memos of ``d`` and every enclosing region op:
        restructuring inside ``d`` leaves ancestor produces/consumes sets
        intact *as sets* but reassociates their float intensity sums and
        leaf walks — a stale memo here would leak into a later query
        (the selfcheck catches exactly this drift)."""
        topo = self._base
        cur: Optional[Op] = d
        seen: set[int] = set()
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            for memo in (topo._produces, topo._consumes, topo._intensity,
                         topo._leaf_meta):
                memo.pop(id(cur), None)
            cur = self._parent.get(id(cur))

    # -- rewrites -----------------------------------------------------------
    def fuse(self, d: Op, a: Op, b: Op) -> Op:
        """Fuse two tasks of one dispatch region into a new task,
        preserving program order (transparent regions make this a pure
        re-wrap).  The merged task's rollups come from O(1) set algebra
        over the memoized operands; the region index is maintained in
        O(Δ): direct edges fold from the fused pair's rows, and only the
        closure rows of tasks whose reachability actually changed (the
        merged task's ancestors and descendants) are rewritten — each
        fold touching just that row's occupied blocks.  Every touched
        row's previous value is logged for an exact inverse, so rollback
        restores the index bit-for-bit."""
        self._check_open()
        idx = self._ensure_region(d)
        region = d.region
        ia, ib = _index_identical(region, a), _index_identical(region, b)
        first, second = (a, b) if ia <= ib else (b, a)
        i = min(ia, ib)
        merged = make_task(list(first.region) + list(second.region))
        old_region = list(region)
        region[i] = merged
        _remove_identical(region, second)

        topo = self._base
        topo.note_fusion(merged, first, second)
        fid, sid, mid = id(first), id(second), id(merged)
        mcons = topo.consumes(merged)
        rank_first = idx.rank[fid]   # == min of the two: rank ≡ region order

        # Fusion is edge *contraction* — almost.  Outgoing edges rename
        # exactly (produces(m) is the full union), and no incoming edge
        # appears from nowhere, but an edge into `second` through a value
        # `first` also produces VANISHES (the value became region-internal
        # to m, so m's live-ins drop it).  Detect that case by re-deriving
        # m's true predecessors from the rollups; when an edge vanished,
        # the incremental closure formula is invalid and the index is
        # rebuilt (rare: it needs a multi-produced Functional value).
        bf, bs = idx.bit[fid], idx.bit[sid]
        succ_m = _row_fold(_row_or(idx.succ[fid], idx.succ[sid]),
                           bf, bs, _ROW_EMPTY)
        pred_renamed = _row_fold(_row_or(idx.pred[fid], idx.pred[sid]),
                                 bf, bs, _ROW_EMPTY)
        pred_m: dict[int, int] = {}
        vanished = False
        for pos in _row_bits(pred_renamed):
            if topo.produces(idx.by_bit[pos]) & mcons:
                pred_m[pos >> 6] = pred_m.get(pos >> 6, 0) | 1 << (pos & 63)
            else:
                vanished = True

        if not vanished:
            # Pure contraction: maintain in O(Δ).  Rows are treated as
            # immutable (folds allocate fresh dicts), so the undo log
            # just keeps the previous row object; only rows incident to
            # m's ancestors / descendants change, and each fold touches
            # only that row's occupied blocks.
            bm = len(idx.by_bit)
            idx.by_bit.append(merged)
            add_m = {bm >> 6: 1 << (bm & 63)}
            old_rows: list[tuple[dict, int, dict]] = []
            reach_m = _row_fold(_row_or(idx.reach[fid], idx.reach[sid]),
                                bf, bs, _ROW_EMPTY)
            rreach_m = _row_fold(_row_or(idx.rreach[fid], idx.rreach[sid]),
                                 bf, bs, _ROW_EMPTY)
            for pos in _row_bits(pred_m):
                tid = id(idx.by_bit[pos])
                old_rows.append((idx.succ, tid, idx.succ[tid]))
                idx.succ[tid] = _row_fold(idx.succ[tid], bf, bs, add_m)
            for pos in _row_bits(succ_m):
                tid = id(idx.by_bit[pos])
                old_rows.append((idx.pred, tid, idx.pred[tid]))
                idx.pred[tid] = _row_fold(idx.pred[tid], bf, bs, add_m)
            add_reach = _row_or(reach_m, add_m)
            for pos in _row_bits(rreach_m):
                tid = id(idx.by_bit[pos])
                old_rows.append((idx.reach, tid, idx.reach[tid]))
                idx.reach[tid] = _row_fold(idx.reach[tid], bf, bs,
                                           add_reach)
            add_rreach = _row_or(rreach_m, add_m)
            for pos in _row_bits(reach_m):
                tid = id(idx.by_bit[pos])
                old_rows.append((idx.rreach, tid, idx.rreach[tid]))
                idx.rreach[tid] = _row_fold(idx.rreach[tid], bf, bs,
                                            add_rreach)
            popped: list[tuple[dict, int, object]] = []
            for table in (idx.succ, idx.pred, idx.reach, idx.rreach,
                          idx.rank, idx.ops, idx.bit):
                for tid in (fid, sid):
                    popped.append((table, tid, table.pop(tid)))
            idx.succ[mid] = succ_m
            idx.pred[mid] = pred_m
            idx.reach[mid] = reach_m
            idx.rreach[mid] = rreach_m
            # The merged task replaces `first` in the region list, so it
            # inherits first's rank — order-consistency and uniqueness
            # hold, and heap keys built from older ranks stay coherent.
            idx.rank[mid] = rank_first
            idx.ops[mid] = merged
            idx.bit[mid] = bm

            def undo_index() -> None:
                for table in (idx.succ, idx.pred, idx.reach, idx.rreach,
                              idx.rank, idx.ops, idx.bit):
                    table.pop(mid, None)
                del idx.by_bit[bm]
                for table, tid, row in old_rows:
                    table[tid] = row
                for table, tid, val in popped:
                    table[tid] = val
        else:
            # A vanished edge invalidated closure deltas: rebuild, but
            # preserve the maintained ranks (heap keys outlive this call).
            # Losing an edge can also *remove* reachability, so cycle
            # verdicts cached by worklists are stale — bump the epoch.
            old_idx = idx
            idx = _build_region_index(topo, d)
            idx.rank = {tid: (rank_first if tid == mid
                              else old_idx.rank[tid])
                        for tid in idx.ops}
            idx.epoch = old_idx.epoch + 1
            self._regions[id(d)] = idx
            self._sample_index_bytes()

            def undo_index() -> None:
                self._regions[id(d)] = old_idx

        self._parent[mid] = d
        for c in merged.region:
            self._parent[id(c)] = merged
        self._pins.append(merged)
        self._invalidate_ancestors(d)

        def undo() -> None:
            region[:] = old_region
            undo_index()
        self._undo.append(undo)
        self._after()
        return merged

    def split(self, d: Op, task: Op, at: int) -> tuple[Op, Op]:
        """Split ``task`` (a region op of dispatch ``d``) into two tasks
        at child index ``at`` — the inverse of :meth:`fuse`.  Splitting
        can *sever* reachability (paths through the merged task may not
        exist through either half), which no closure delta expresses
        cheaply, so the region index is rebuilt (ranks reset to the
        current region order); split is an API-completeness primitive,
        not a worklist step — no pass splits mid-heap."""
        self._check_open()
        if not 0 < at < len(task.region):
            raise RewriteError(f"split index {at} out of range for "
                               f"{task.name} ({len(task.region)} children)")
        old_idx = self._ensure_region(d)
        region = d.region
        i = _index_identical(region, task)
        head = make_task(list(task.region[:at]))
        tail = make_task(list(task.region[at:]))
        old_region = list(region)
        region[i:i + 1] = [head, tail]

        for part in (head, tail):
            self._parent[id(part)] = d
            for c in part.region:
                self._parent[id(c)] = part
            self._pins.append(part)
        new_idx = _build_region_index(self._base, d)
        new_idx.epoch = old_idx.epoch + 1   # reachability may have shrunk
        self._regions[id(d)] = new_idx
        self._sample_index_bytes()
        self._invalidate_ancestors(d)

        def undo() -> None:
            region[:] = old_region
            self._regions[id(d)] = old_idx
        self._undo.append(undo)
        self._after()
        return head, tail

    def wrap_dispatch(self, owner: Optional[Op]) -> Op:
        """Construction primitive (paper Alg. 1): wrap every op of
        ``owner``'s region (or the graph's top level when ``owner`` is
        None) into its own ``task`` — existing tasks/dispatches pass
        through — and the whole list into one ``dispatch`` that replaces
        the region's content.

        Leaf ops are untouched, so the value→op indices stay valid
        verbatim; only the parent map grows (O(wrapped) new entries).
        That is what lets ``construct_functional`` run transactionally
        *and* hand the fusion pass a warm topology at commit instead of
        forcing the full rebuild the pre-session construct pass caused."""
        self._check_open()
        if self._canonicalized:
            raise RewriteError("wrap_dispatch after canonicalize()")
        container = owner.region if owner is not None else self.graph.ops
        old = list(container)
        tasks = [o if o.kind in ("task", "dispatch") else make_task([o])
                 for o in old]
        d = make_dispatch(tasks)
        container[:] = [d]

        old_parents = {id(o): self._parent.get(id(o)) for o in old}
        self._parent[id(d)] = owner
        for t, o in zip(tasks, old):
            self._parent[id(t)] = d
            if t is not o:
                self._parent[id(o)] = t
        self._pins.append(d)
        self._pins.extend(t for t, o in zip(tasks, old) if t is not o)
        if owner is not None:
            self._invalidate_ancestors(owner)

        def undo() -> None:
            container[:] = old
            self._parent.pop(id(d), None)
            for t, o in zip(tasks, old):
                if t is not o:
                    self._parent.pop(id(t), None)
            for oid, par in old_parents.items():
                self._parent[oid] = par
        self._undo.append(undo)
        self._after()
        return d

    def canonicalize(self, fn: Callable[[Op], Op]) -> None:
        """Wholesale region-tree restructure (e.g.
        :func:`~repro_torch.core.fusion.simplify_hierarchy`): apply ``fn`` to
        every top-level op.  This invalidates the maintained topology at
        commit (the one full rebuild happens lazily on the next
        ``graph.topology()`` call, *after* the worklist is done — never
        between worklist steps)."""
        self._check_open()
        g = self.graph
        # fn may rewrite or REBIND op.region at any depth: snapshot both
        # the list object and its content for an exact inverse.  Identity
        # matters — earlier fuse/split undos captured these very list
        # objects, so the inverse must restore content *into them* and
        # re-point op.region at them, or a later rollback would mutate an
        # orphaned list while the op shows the canonicalized one.
        snapshot = [(op, op.region, list(op.region)) for op in g.walk()]
        ops_obj = g.ops
        old_ops = list(g.ops)

        def undo() -> None:
            for op, region_obj, children in snapshot:
                region_obj[:] = children
                op.region = region_obj
            ops_obj[:] = old_ops
            g.ops = ops_obj
        # Logged before fn runs: simplify-style callbacks mutate the tree
        # while traversing, so an exception mid-apply must still restore.
        self._undo.append(undo)
        self._canonicalized = True
        g.ops = [fn(o) for o in g.ops]

    # -- selfcheck ----------------------------------------------------------
    def _after(self) -> None:
        if self._selfcheck:
            self.selfcheck()

    def selfcheck(self) -> None:
        """Assert every maintained structure equals a from-scratch
        rebuild (property-test / debugging hook; O(graph) per call)."""
        g = self.graph
        fresh = GraphTopology.build(g)
        live = {id(o) for o in g.walk()}
        # Rollups for every live op the memo knows about.
        for op in list(g.walk()):
            assert self._base.produces(op) == frozenset(op.all_outs()), \
                f"produces drift on {op.name}"
            assert self._base.consumes(op) == frozenset(op.all_ins()), \
                f"consumes drift on {op.name}"
            assert self._base.intensity(op) == op.intensity(), \
                f"intensity drift on {op.name}"
        # Parent map over live ops.
        maintained_parent = {
            o.name: (self._parent.get(id(o)).name
                     if self._parent.get(id(o)) is not None else None)
            for o in g.walk()}
        fresh_parent = {
            o.name: (fresh.parent[id(o)].name
                     if fresh.parent[id(o)] is not None else None)
            for o in g.walk()}
        assert maintained_parent == fresh_parent, "parent map drift"
        # Region indices for every ensured dispatch still in the graph:
        # direct edges, the reachability closure (vs a from-scratch DFS),
        # its inverse, and the program-order rank invariant.
        by_id = {id(o): o for o in g.walk()}
        for did, idx in self._regions.items():
            d = by_id.get(did)
            if d is None or d.kind != "dispatch":
                continue
            fresh_succ = {}
            for i, a in enumerate(d.region):
                fresh_succ[id(a)] = {
                    id(b) for j, b in enumerate(d.region)
                    if i != j and frozenset(a.all_outs()) & frozenset(
                        b.all_ins())}
            assert set(idx.ops) == {id(t) for t in d.region}, \
                f"live-task drift in {d.name}"

            def ids_of(mask: int) -> set[int]:
                return {id(t) for t in idx.tasks(mask)}

            maintained_succ = {k: ids_of(v) for k, v in idx.succ.items()}
            assert maintained_succ == fresh_succ, f"succ drift in {d.name}"
            fresh_pred = {k: set() for k in fresh_succ}
            for s, row in fresh_succ.items():
                for t in row:
                    fresh_pred[t].add(s)
            maintained_pred = {k: ids_of(v) for k, v in idx.pred.items()}
            assert maintained_pred == fresh_pred, f"pred drift in {d.name}"
            fresh_reach = {}
            for tid in fresh_succ:
                seen: set[int] = set()
                stack = list(fresh_succ[tid])
                while stack:
                    n = stack.pop()
                    if n in seen:
                        continue
                    seen.add(n)
                    stack.extend(fresh_succ[n])
                seen.discard(tid)
                fresh_reach[tid] = seen
            maintained_reach = {k: ids_of(v) for k, v in idx.reach.items()}
            assert maintained_reach == fresh_reach, f"reach drift in {d.name}"
            fresh_rreach = {k: set() for k in fresh_reach}
            for s, row in fresh_reach.items():
                for t in row:
                    fresh_rreach[t].add(s)
            maintained_rreach = {k: ids_of(v) for k, v in idx.rreach.items()}
            assert maintained_rreach == fresh_rreach, \
                f"rreach drift in {d.name}"
            ranks = [idx.rank[id(t)] for t in d.region]
            assert ranks == sorted(ranks) and len(set(ranks)) == len(ranks), \
                f"rank order drift in {d.name}"


# --------------------------------------------------------------------------
# Structural-level session
# --------------------------------------------------------------------------

class ScheduleRewriteSession:
    """Transactional rewrites over a Structural :class:`Schedule`.

    Maintains the producer/consumer indices of
    :class:`ScheduleTopology` in O(Δ) per primitive and re-derives the
    per-buffer axis structures only for buffers a rewrite actually
    touched; :meth:`commit` installs the result as the schedule's cached
    topology (so the downstream DSE starts on a warm cache), and
    :meth:`rollback` restores the schedule and its pre-session topology
    exactly."""

    def __init__(self, sched: Schedule, selfcheck: bool = False):
        self.sched = sched
        self._base = sched.topology()
        self._producers = {b: list(v) for b, v in self._base.producers.items()}
        self._consumers = {b: list(v) for b, v in self._base.consumers.items()}
        self._pos = {n.name: i for i, n in enumerate(sched.nodes)}
        self._dirty: set[str] = set()
        # Per-buffer edge buckets: the canonical edge list is the
        # concatenation of buckets in ``sched.buffers`` order, and a
        # rewrite only invalidates the buckets of the buffers it touched
        # — a 1k-dispatch balance pass regenerates a handful of buckets
        # instead of re-deriving the whole O(buffers·degree) list.
        self._edge_buckets: dict[str, list[tuple[str, str, str]]] = {}
        for e in self._base.edges:
            self._edge_buckets.setdefault(e[2], []).append(e)
        self._stale_buckets: set[str] = set()
        self._edges: Optional[list[tuple[str, str, str]]] = list(
            self._base.edges)
        # Memoized order/depth over the maintained edges.  The depth map
        # is Δ-maintained across pure insertions (add_node can only
        # deepen paths through the new node — a bounded worklist
        # propagation); any shrinking primitive drops it for a lazy full
        # recompute.  Equality with the from-scratch walks is pinned by
        # tests/test_rewrite.py.
        self._order_memo: Optional[list[Node]] = None
        self._depth_memo: Optional[dict[str, int]] = None
        self._undo: list[Callable[[], None]] = []
        self._open = True
        self._selfcheck = selfcheck

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "ScheduleRewriteSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if not self._open:
            return
        if exc_type is None:
            try:
                self.commit()
            except BaseException:
                # A commit-time failure must not leave a half-mutated
                # schedule behind: the undo log is still intact, replay it.
                if self._open:
                    self.rollback()
                raise
        else:
            self.rollback()

    def _check_open(self) -> None:
        if not self._open:
            raise RewriteError("schedule rewrite session is closed")

    def commit(self) -> ScheduleTopology:
        """Assemble the maintained topology, install it as the
        schedule's cache, and close the session."""
        self._check_open()
        fault_point("rewrite.commit")
        topo = self._assemble()
        self._open = False
        self.sched._topology = topo
        return topo

    def rollback(self) -> None:
        """Undo every rewrite (exact inverses, reverse order) and
        reinstate the untouched pre-session topology.  The base's lazy
        per-(node, buffer) access cache is dropped: an entry computed
        mid-session (e.g. an external ``access_for`` query) reflects a
        mutated node body and must not survive into the restored one."""
        self._check_open()
        self._open = False
        for undo in reversed(self._undo):
            undo()
        if self._undo:
            self._base._access.clear()
        self.sched._topology = self._base

    def _assemble(self) -> ScheduleTopology:
        sched = self.sched
        sig = sched.structure_signature()
        base = self._base
        if sig == base.signature and not self._dirty:
            return base
        producers = {b: list(v) for b, v in self._producers.items() if v}
        consumers = {b: list(v) for b, v in self._consumers.items() if v}
        edges = self._edge_list()
        access: dict[tuple[str, str], Optional[AccessMap]] = {}
        axis_owner_dims: dict[str, tuple] = {}
        axis_dims: dict[str, tuple] = {}
        for bname, buf in sched.buffers.items():
            if bname not in self._dirty and bname in base.axis_owner_dims:
                # Untouched buffer: owners and their access maps are
                # unchanged — reuse the pre-session derivation.
                axis_owner_dims[bname] = base.axis_owner_dims[bname]
                axis_dims[bname] = base.axis_dims[bname]
                continue
            owners = producers.get(bname, []) + consumers.get(bname, [])
            per_axis: list[tuple] = []
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
        buffers_of_dim: dict[str, list[str]] = {}
        for bname in sched.buffers:
            for d in axis_dims[bname]:
                if d is not None and (d not in buffers_of_dim
                                      or buffers_of_dim[d][-1] != bname):
                    buffers_of_dim.setdefault(d, []).append(bname)
        return ScheduleTopology(
            producers=producers, consumers=consumers, edges=edges,
            axis_owner_dims=axis_owner_dims, axis_dims=axis_dims,
            buffers_of_dim={d: tuple(v) for d, v in buffers_of_dim.items()},
            _access=access, signature=sig)

    # -- queries ------------------------------------------------------------
    def producers(self, value: str) -> list[Node]:
        """Nodes writing ``value``, in node order."""
        return list(self._producers.get(value, ()))

    def consumers(self, value: str) -> list[Node]:
        """Nodes reading ``value``, in node order."""
        return list(self._consumers.get(value, ()))

    def owners(self, value: str) -> list[Node]:
        """Producers then consumers — the plan-projection scan order."""
        return self.producers(value) + self.consumers(value)

    def users_in_program_order(self, value: str) -> list[Node]:
        """Every node with ``value`` in its args, ascending node order,
        deduplicated (an RW node indexes as both producer and consumer)."""
        seen: set[str] = set()
        out: list[Node] = []
        nodes = (self._producers.get(value, [])
                 + self._consumers.get(value, []))
        for n in sorted(nodes, key=lambda n: self._pos[n.name]):
            if n.name not in seen:
                seen.add(n.name)
                out.append(n)
        return out

    def position(self, node: Node) -> int:
        return self._pos[node.name]

    def _edge_list(self) -> list[tuple[str, str, str]]:
        if self._edges is None:
            buckets = self._edge_buckets
            for b in self._stale_buckets:
                bucket = []
                for p in self._producers.get(b, ()):
                    for c in self._consumers.get(b, ()):
                        if p.name != c.name:
                            bucket.append((p.name, c.name, b))
                if bucket:
                    buckets[b] = bucket
                else:
                    buckets.pop(b, None)
            self._stale_buckets.clear()
            self._edges = [e for b in self.sched.buffers if b in buckets
                           for e in buckets[b]]
        return self._edges

    def edges(self) -> list[tuple[str, str, str]]:
        """(src, dst, buffer) edges over the current structure, in the
        canonical ``ScheduleTopology.build`` order (only the buckets of
        buffers a rewrite touched are regenerated from the Δ-maintained
        indices; untouched buckets are reused verbatim)."""
        return list(self._edge_list())

    def topo_order(self) -> list[Node]:
        """Stable topological order over the maintained edges, memoized
        until the next structural rewrite (stage-assignment and the
        region partitioner query it repeatedly between rewrites)."""
        if self._order_memo is None:
            self._order_memo = topo_order_over(
                self.sched.nodes, self._edge_list(), self.sched.name)
        return list(self._order_memo)

    def depth_of(self) -> dict[str, int]:
        """Longest-path depth per node over the maintained edges.
        Memoized, and Δ-maintained across :meth:`add_node` (a pure
        insertion only deepens paths through the new node, so a bounded
        worklist propagation replaces the full O(V+E) rebuild the
        balance pass used to pay per query)."""
        if self._depth_memo is None:
            self._depth_memo = depth_map_over(
                self.sched.nodes, self._edge_list(), self.sched.name)
        return dict(self._depth_memo)

    def dse_regions(self, *, max_cut: int = 2,
                    min_nodes: int | None = None,
                    max_nodes: int | None = None) -> "list[RegionSpec]":
        """Region partition for the hierarchical DSE over the session's
        Δ-maintained edge list (same contract as the module-level
        :func:`dse_regions`, without forcing a topology rebuild
        mid-session).  ``min_nodes`` / ``max_nodes`` default to the
        scale-aware :func:`default_region_bounds`."""
        mn, mx = default_region_bounds(len(self.sched.nodes))
        return _dse_regions_over(self.sched.nodes, self._edge_list(),
                                 self.sched.name, max_cut=max_cut,
                                 min_nodes=mn if min_nodes is None
                                 else min_nodes,
                                 max_nodes=mx if max_nodes is None
                                 else max_nodes,
                                 order=self.topo_order())

    # -- index maintenance ---------------------------------------------------
    def _touch(self, *values: str) -> None:
        self._dirty.update(values)
        self._stale_buckets.update(values)
        self._edges = None
        self._order_memo = None
        self._depth_memo = None

    def _reindex_positions(self) -> None:
        self._pos = {n.name: i for i, n in enumerate(self.sched.nodes)}

    def _index_insert(self, index: dict[str, list[Node]], value: str,
                      node: Node) -> None:
        lst = index.setdefault(value, [])
        if any(x is node for x in lst):
            return
        pos = self._pos[node.name]
        at = len(lst)
        for j, other in enumerate(lst):
            if self._pos[other.name] > pos:
                at = j
                break
        lst.insert(at, node)

    def _index_discard(self, index: dict[str, list[Node]], value: str,
                       node: Node) -> None:
        lst = index.get(value)
        if lst is not None:
            _remove_identical(lst, node)

    def _propagate_depth(self, depth: dict[str, int], node: Node
                         ) -> Optional[dict[str, int]]:
        """Depth map after inserting ``node``: a pure insertion only
        *adds* edges, and longest-path depth is monotone under edge
        addition, so relaxing from the insertion point reproduces the
        full recompute exactly.  Returns ``None`` — forcing the lazy
        full rebuild — if the relaxation fails to settle within a
        generous pop budget (only possible when the insertion created a
        cycle, where the rebuild is the path that raises)."""
        d0 = 0
        for b in node.reads():
            for p in self._producers.get(b, ()):
                if p is not node and p.name in depth:
                    d0 = max(d0, depth[p.name] + 1)
        depth[node.name] = d0
        budget = 8 * (len(depth) + 1)
        work = [node]
        while work:
            budget -= 1
            if budget < 0:
                return None
            src = work.pop()
            ds = depth[src.name]
            for b in src.writes():
                for c in self._consumers.get(b, ()):
                    if c is not src and depth.get(c.name, 0) < ds + 1:
                        depth[c.name] = ds + 1
                        work.append(c)
        return depth

    def _sync_arg_index(self, node: Node, value: str) -> None:
        """Make the two indices agree with ``node.args.get(value)``."""
        effect = node.args.get(value)
        if effect in (MemoryEffect.WRITE, MemoryEffect.READ_WRITE):
            self._index_insert(self._producers, value, node)
        else:
            self._index_discard(self._producers, value, node)
        if effect in (MemoryEffect.READ, MemoryEffect.READ_WRITE):
            self._index_insert(self._consumers, value, node)
        else:
            self._index_discard(self._consumers, value, node)

    def _after(self) -> None:
        if self._selfcheck:
            self.selfcheck()

    def selfcheck(self) -> None:
        """Assert the maintained topology equals a from-scratch build
        (property-test / debugging hook; O(schedule) per call)."""
        fresh = ScheduleTopology.build(self.sched)
        assert (schedule_topology_fingerprint(self._assemble())
                == schedule_topology_fingerprint(fresh)), \
            f"topology drift on schedule {self.sched.name}"

    # -- node primitives -----------------------------------------------------
    def add_node(self, node: Node, index: int | None = None) -> Node:
        """Insert ``node`` (at ``index``, default append) and index its
        argument effects."""
        self._check_open()
        sched = self.sched
        # _pos mirrors sched.nodes exactly, so membership there is the
        # duplicate check (the old any() scan was O(n) per insert —
        # quadratic over a 5k-node lowering).
        if node.name in self._pos:
            raise RewriteError(f"duplicate node {node.name}")
        at = len(sched.nodes) if index is None else index
        sched.nodes.insert(at, node)
        if at == len(sched.nodes) - 1:
            # Append fast path: no existing position shifts, so the
            # full O(n) renumber reduces to one dict store.
            self._pos[node.name] = at
        else:
            # Mid-insert: only suffix positions shift, so bump those in
            # place instead of rebuilding the whole dict (balance does
            # ~n mid-inserts; full rebuilds made that quadratic).
            pos = self._pos
            for n in sched.nodes[at + 1:]:
                pos[n.name] += 1
            pos[node.name] = at
        # Keep the schedule's name→Node lookup cache live instead of
        # letting the length change force an O(n) rebuild per insert
        # (balance alone does ~n inserts).
        if sched._node_cache is not None:
            sched._node_cache[node.name] = node
            sched._node_cache_len = len(sched.nodes)
        for b in node.writes():
            self._index_insert(self._producers, b, node)
        for b in node.reads():
            self._index_insert(self._consumers, b, node)
        depth = self._depth_memo
        self._touch(*node.args)
        if depth is not None:
            # Pure insertion: Δ-maintain the depth memo instead of
            # letting _touch force a full O(V+E) rebuild on next query.
            self._depth_memo = self._propagate_depth(depth, node)

        def undo() -> None:
            # Undos run LIFO, so the list state here is exactly the
            # post-insert state: a positional delete is the precise
            # inverse (and O(1) at the tail, vs the old O(n) snapshot
            # copy taken on every insert).  Mirror the insert's
            # shift-only position update.
            del sched.nodes[at]
            pos = self._pos
            del pos[node.name]
            for n in sched.nodes[at:]:
                pos[n.name] -= 1
        self._undo.append(undo)
        self._after()
        return node

    def retire_node(self, node: Node) -> None:
        """Remove ``node`` from the schedule and the indices."""
        self._check_open()
        sched = self.sched
        old_nodes = list(sched.nodes)
        if not _remove_identical(sched.nodes, node):
            raise RewriteError(f"unknown node {node.name}")
        # Drop (not patch) the name cache: a later 1-for-1 replace keeps
        # the list length, so the length check alone can't catch a stale
        # hit on the retired name.
        sched._node_cache = None
        self._reindex_positions()
        for b in node.writes():
            self._index_discard(self._producers, b, node)
        for b in node.reads():
            self._index_discard(self._consumers, b, node)
        self._touch(*node.args)

        def undo() -> None:
            sched.nodes[:] = old_nodes
            # add_node's shift-only undo assumes _pos mirrors the list,
            # so restoring the list must restore the mirror too.
            self._reindex_positions()
        self._undo.append(undo)
        self._after()

    def replace_nodes(self, olds: Sequence[Node], new: Node,
                      index: int) -> Node:
        """Atomically retire ``olds`` and insert ``new`` at ``index`` —
        the multi-producer *fusion* arm (Alg. 3 case 2).  The caller
        builds ``new`` (body concatenation, effect merging are pass
        policy); the session owns the structural swap and re-indexing."""
        self._check_open()
        sched = self.sched
        old_nodes = list(sched.nodes)
        for o in olds:
            if not _remove_identical(sched.nodes, o):
                raise RewriteError(f"unknown node {o.name}")
        sched.nodes.insert(index, new)
        # See retire_node: a 1-for-1 swap preserves the list length, so
        # the name cache must be dropped, not patched.
        sched._node_cache = None
        self._reindex_positions()
        touched: set[str] = set(new.args)
        for o in olds:
            touched.update(o.args)
            for b in o.writes():
                self._index_discard(self._producers, b, o)
            for b in o.reads():
                self._index_discard(self._consumers, b, o)
        for b in new.writes():
            self._index_insert(self._producers, b, new)
        for b in new.reads():
            self._index_insert(self._consumers, b, new)
        self._touch(*touched)

        def undo() -> None:
            sched.nodes[:] = old_nodes
            # See retire_node's undo: keep the _pos mirror in sync.
            self._reindex_positions()
        self._undo.append(undo)
        self._after()
        return new

    # -- argument / body primitives ------------------------------------------
    def set_arg(self, node: Node, value: str, effect: str) -> None:
        """Set ``node.args[value] = effect`` (dict position preserved for
        an existing key, appended for a new one) and re-index."""
        self._check_open()
        old_args = dict(node.args)
        node.args[value] = effect
        self._sync_arg_index(node, value)
        self._touch(value)

        def undo() -> None:
            node.args.clear()
            node.args.update(old_args)
        self._undo.append(undo)
        self._after()

    def drop_arg(self, node: Node, value: str) -> None:
        """Remove ``value`` from ``node.args`` and the indices (used by
        lowering to drop node-internal temporaries)."""
        self._check_open()
        old_args = dict(node.args)
        node.args.pop(value, None)
        self._index_discard(self._producers, value, node)
        self._index_discard(self._consumers, value, node)
        self._touch(value)

        def undo() -> None:
            node.args.clear()
            node.args.update(old_args)
        self._undo.append(undo)
        self._after()

    def rename_arg(self, node: Node, old: str, new: str) -> None:
        """Re-point every use of ``old`` inside ``node`` (args entry, body
        op operands, access-map keys) at ``new`` — the
        ``replace_uses``-per-node primitive of multi-producer elimination
        and balancing."""
        self._check_open()
        old_args = dict(node.args)
        body_snapshot = [(o, list(o.ins), list(o.outs), dict(o.access))
                         for o in node.body]
        if old in node.args:
            node.args[new] = node.args.pop(old)
        for o in node.body:
            o.ins = [new if v == old else v for v in o.ins]
            o.outs = [new if v == old else v for v in o.outs]
            if old in o.access:
                o.access[new] = o.access.pop(old)
        self._index_discard(self._producers, old, node)
        self._index_discard(self._consumers, old, node)
        self._sync_arg_index(node, new)
        self._touch(old, new)

        def undo() -> None:
            node.args.clear()
            node.args.update(old_args)
            for o, ins, outs, access in body_snapshot:
                o.ins = ins
                o.outs = outs
                o.access = access
        self._undo.append(undo)
        self._after()

    def replace_uses(self, old: str, new: str,
                     nodes: Iterable[Node]) -> None:
        """:meth:`rename_arg` over a node subset (e.g. the dominated uses
        of a duplicated buffer)."""
        for n in nodes:
            self.rename_arg(n, old, new)

    def insert_copy(self, node: Node, buf: Buffer, src: str,
                    dst: str) -> Op:
        """Prepend an explicit memory copy ``src -> dst`` to ``node``
        (paper Alg. 3 lines 5-7) and record the new READ effect."""
        self._check_open()
        old_args = dict(node.args)
        old_body = list(node.body)
        op = make_copy_op(buf, src, dst)
        node.body.insert(0, op)
        node.args[src] = MemoryEffect.READ
        self._sync_arg_index(node, src)
        self._touch(src, dst)

        def undo() -> None:
            node.args.clear()
            node.args.update(old_args)
            node.body[:] = old_body
        self._undo.append(undo)
        self._after()
        return op

    # -- buffer / stream primitives -------------------------------------------
    def add_buffer(self, buf: Buffer, external: bool = False) -> Buffer:
        """Register a new buffer (optionally as a schedule argument)."""
        self._check_open()
        sched = self.sched
        if buf.name in sched.buffers:
            raise RewriteError(f"duplicate buffer {buf.name}")
        sched.buffers[buf.name] = buf
        if external:
            sched.args.append(buf.name)
        self._touch(buf.name)

        def undo() -> None:
            del sched.buffers[buf.name]
            if external:
                sched.args.remove(buf.name)
        self._undo.append(undo)
        self._after()
        return buf

    def rename_buffer(self, old: str, new: str) -> None:
        """Rename a buffer everywhere: the buffers dict key, the args
        list, and every owning node (args + body operands)."""
        self._check_open()
        sched = self.sched
        if old not in sched.buffers:
            raise RewriteError(f"unknown buffer {old}")
        if new in sched.buffers:
            raise RewriteError(f"duplicate buffer {new}")
        for n in self.users_in_program_order(old):
            self.rename_arg(n, old, new)
        buf = sched.buffers[old]
        old_buffers = dict(sched.buffers)
        old_args = list(sched.args)
        old_outputs = list(sched.outputs)
        old_value_bytes = dict(sched.value_bytes)
        old_name = buf.name
        sched.buffers = {(new if k == old else k): v
                         for k, v in sched.buffers.items()}
        buf.name = new
        sched.args = [new if a == old else a for a in sched.args]
        sched.outputs = [new if o == old else o for o in sched.outputs]
        # The estimator costs reduction collectives off value_bytes; a
        # stale key would silently zero this buffer's traffic.
        sched.value_bytes = {(new if k == old else k): v
                             for k, v in sched.value_bytes.items()}
        self._touch(old, new)

        def undo() -> None:
            buf.name = old_name
            sched.buffers = old_buffers
            sched.args[:] = old_args
            sched.outputs[:] = old_outputs
            sched.value_bytes = old_value_bytes
        self._undo.append(undo)
        self._after()

    def set_buffer_attrs(self, name: str, *, stages: int | None = None,
                         placement: str | None = None) -> None:
        """Adjust ping-pong depth / placement (the soft-FIFO transform).
        Neither attribute participates in the topology, so no index
        maintenance is needed — but the change still logs an inverse."""
        self._check_open()
        buf = self.sched.buffers[name]
        old = (buf.stages, buf.placement)
        if stages is not None:
            buf.stages = stages
        if placement is not None:
            buf.placement = placement

        def undo() -> None:
            buf.stages, buf.placement = old
        self._undo.append(undo)
        self._after()

    def add_token(self, src: str, dst: str) -> TokenEdge:
        """Append an elastic-ordering token edge (Section 6.4.2)."""
        self._check_open()
        edge = TokenEdge(src=src, dst=dst)
        self.sched.tokens.append(edge)

        def undo() -> None:
            _remove_identical(self.sched.tokens, edge)
        self._undo.append(undo)
        self._after()
        return edge

    # -- schedule-level attributes --------------------------------------------
    def set_stage(self, node: Node, stage: int) -> None:
        """Pipeline-stage assignment (not a topology input, but staged
        state must still be transactional so callers can never observe a
        half-applied mapping)."""
        self._check_open()
        old = node.stage
        node.stage = stage

        def undo() -> None:
            node.stage = old
        self._undo.append(undo)

    def set_outputs(self, outputs: Sequence[str]) -> None:
        self._check_open()
        sched = self.sched
        old = list(sched.outputs)
        sched.outputs = list(outputs)

        def undo() -> None:
            sched.outputs = old
        self._undo.append(undo)

    def set_value_bytes(self, value_bytes: dict[str, int]) -> None:
        self._check_open()
        sched = self.sched
        old = dict(sched.value_bytes)
        sched.value_bytes = dict(value_bytes)

        def undo() -> None:
            sched.value_bytes = old
        self._undo.append(undo)


# --------------------------------------------------------------------------
# Region partitions for the hierarchical DSE
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class RegionSpec:
    """One contiguous slice of the schedule's topological order, exported
    to the two-level DSE (paper Section 4: solve each dataflow node's
    local space, compose at the inter-node level).

    The partition contract (see docs/ARCHITECTURE.md):

    * ``nodes`` is a contiguous run of the stable topological order —
      every node belongs to exactly one region, and concatenating the
      regions in ``index`` order reproduces the topo order exactly.
    * ``boundary`` lists the shared-buffer edges with exactly one
      endpoint inside the region (both directions), in canonical
      topology-edge order — the only coupling the outer composition
      level has to score.
    * Cuts are chosen where few edges cross (layer seams in the LM
      configs), so inner searches see almost all of their QoR terms.
    """

    index: int
    nodes: tuple[str, ...]
    #: (src, dst, buffer) edges crossing the region border.
    boundary: tuple[tuple[str, str, str], ...]


def default_region_bounds(n: int) -> tuple[int, int]:
    """Scale-aware ``(min_nodes, max_nodes)`` for :func:`dse_regions`.

    Schedules up to 256 nodes get the historical ``(3, 16)`` — every
    existing config (≤43 nodes) partitions bit-identically.  Beyond
    that, the region cap grows as ~√n, so region count and per-region
    inner-DSE cost grow together: at 10k nodes the fixed cap would
    produce ~600 three-to-sixteen-node regions (outer composition
    dominates), while √n yields ~100 regions of ~100 nodes — both
    levels stay beam-sized."""
    if n <= 256:
        return 3, 16
    mx = max(16, math.isqrt(n - 1) + 1)
    return max(3, mx // 5), mx


def dse_regions(sched: Schedule,
                topology: ScheduleTopology | None = None, *,
                max_cut: int = 2, min_nodes: int | None = None,
                max_nodes: int | None = None) -> list[RegionSpec]:
    """Partition ``sched`` into dispatch regions for the hierarchical DSE.

    Walks the stable topological order and cuts at boundaries crossed by
    at most ``max_cut`` shared-buffer edges (first such boundary once the
    open region holds ``min_nodes``); a region is force-closed at its
    cheapest seen boundary when it would exceed ``max_nodes``.  The walk
    depends only on the topology (edge structure + program order), never
    on node *names*, so the partition — and every boundary signature
    derived from it — is stable under node renaming.

    ``min_nodes`` / ``max_nodes`` default to the scale-aware
    :func:`default_region_bounds` (identical to the historical ``(3,
    16)`` for schedules up to 256 nodes).

    Returns a single whole-schedule region when the schedule is too small
    to split (callers treat that as "run the flat beam").
    """
    topo = topology if topology is not None else sched.topology()
    mn, mx = default_region_bounds(len(sched.nodes))
    return _dse_regions_over(sched.nodes, topo.edges, sched.name,
                             max_cut=max_cut,
                             min_nodes=mn if min_nodes is None
                             else min_nodes,
                             max_nodes=mx if max_nodes is None
                             else max_nodes)


def _dse_regions_over(nodes: Sequence[Node],
                      edge_iter: Iterable[tuple[str, str, str]],
                      name: str, *, max_cut: int, min_nodes: int,
                      max_nodes: int,
                      order: Sequence[Node] | None = None
                      ) -> list[RegionSpec]:
    edges = list(edge_iter)
    if order is None:
        order = topo_order_over(nodes, edges, name)
    names = [n.name for n in order]
    n = len(names)
    if n < 2 * min_nodes:
        return [RegionSpec(index=0, nodes=tuple(names), boundary=())]

    pos = {nm: i for i, nm in enumerate(names)}
    # crossing[b] = edges spanning the boundary between order[b-1] and
    # order[b]; an edge (s, d) crosses every boundary in (pos[s], pos[d]]
    # — accumulated as a difference array (+1 at lo+1, −1 at hi+1, prefix
    # sum), O(E + n) instead of the former O(E · span) inner loop that
    # dominated at 5k+ nodes.
    diff = [0] * (n + 2)
    for s, d, _b in edges:
        lo, hi = pos[s], pos[d]
        if lo > hi:
            lo, hi = hi, lo
        diff[lo + 1] += 1
        diff[hi + 1] -= 1
    crossing = [0] * (n + 1)
    run = 0
    for b in range(n + 1):
        run += diff[b]
        crossing[b] = run

    cuts: list[int] = []
    start = 0
    best_b: int | None = None  # cheapest boundary seen in the open region
    for b in range(start + 1, n):
        if b - start >= min_nodes and (
                best_b is None or crossing[b] < crossing[best_b]):
            best_b = b
        closeable = b - start >= min_nodes and n - b >= min_nodes
        if closeable and crossing[b] <= max_cut:
            cuts.append(b)
            start, best_b = b, None
        elif b - start >= max_nodes and best_b is not None \
                and n - best_b >= min_nodes:
            cuts.append(best_b)
            start, best_b = best_b, None
    if not cuts:
        return [RegionSpec(index=0, nodes=tuple(names), boundary=())]

    bounds = [0] + cuts + [n]
    region_of: dict[str, int] = {}
    for r in range(len(bounds) - 1):
        for nm in names[bounds[r]:bounds[r + 1]]:
            region_of[nm] = r
    boundary: list[list[tuple[str, str, str]]] = [
        [] for _ in range(len(bounds) - 1)]
    for s, d, bname in edges:
        rs, rd = region_of[s], region_of[d]
        if rs != rd:
            boundary[rs].append((s, d, bname))
            boundary[rd].append((s, d, bname))
    return [
        RegionSpec(index=r, nodes=tuple(names[bounds[r]:bounds[r + 1]]),
                   boundary=tuple(boundary[r]))
        for r in range(len(bounds) - 1)]
