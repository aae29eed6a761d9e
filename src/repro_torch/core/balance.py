"""Data-path balancing — paper Section 6.4.2.

A dataflow with unequal-length paths stalls: a producer cannot issue the
next frame until the *longest* downstream path drains (ResNet shortcuts are
the canonical case; in LMs it is the residual stream skipping a heavy
attention/FFN/expert path, and in pipeline-parallel execution it is any
skip connection crossing stage boundaries).

Two mechanisms, chosen per buffer by a byte-budget heuristic:

1. **On-chip buffer duplication** — insert ``skew`` copy nodes along the
   short path, one per level of imbalance, each with its own duplicate
   buffer (Fig. 8(b)).  On TPU these become the extra staging slots the
   pipeline runtime carries for skip tensors.

2. **Soft FIFO in external memory** — for large tensors, mark the buffer as
   an ``external`` soft FIFO with ``stages = skew + 1`` and *rotate access
   indices* instead of shifting data (Fig. 8(c)); explicit ``TokenEdge``s
   keep producer/consumer ordering elastic (no FSM — on TPU the rotation is
   a circular microbatch index and the tokens are data dependencies /
   optimization barriers for host-offload staging).

The skew analysis reads the cached
:class:`~repro_torch.core.ir.ScheduleTopology` edges, and every mutation (copy
nodes, duplicate buffers, consumer re-pointing, soft-FIFO attributes,
token edges) flows through one transactional
:class:`~repro_torch.core.rewrite.ScheduleRewriteSession`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .faults import fault_point
from .ir import Buffer, MemoryEffect, Node, Schedule, fresh_name
from .rewrite import ScheduleRewriteSession, make_copy_op


@dataclass
class BalanceStats:
    copy_nodes: int = 0
    soft_fifos: int = 0
    max_skew: int = 0
    log: list[str] = field(default_factory=list)


def path_skew(sched: Schedule) -> dict[tuple[str, str, str], int]:
    """Per (producer, consumer, buffer) edge: depth(consumer) - depth
    (producer) - 1, i.e. how many pipeline levels the edge skips.  Both
    the edge list and the depths come from the cached topology."""
    depth = sched.depth_of()
    return {(s, d, b): depth[d] - depth[s] - 1 for s, d, b in sched.edges()}


def balance_paths(sched: Schedule, onchip_budget_bytes: int = 1 << 27,
                  selfcheck: bool = False) -> BalanceStats:
    stats = BalanceStats()
    with ScheduleRewriteSession(sched, selfcheck=selfcheck) as rs:
        # The skew map is computed once against the pre-balance topology
        # (inserting a copy node shifts downstream depths; re-deriving
        # mid-pass would over-balance), straight off the session's edges.
        depth = rs.depth_of()
        skews = {(s, d, b): depth[d] - depth[s] - 1
                 for s, d, b in rs.edges()}
        for (src, dst, bname), skew in sorted(skews.items()):
            if skew <= 0:
                continue
            stats.max_skew = max(stats.max_skew, skew)
            fault_point("balance.edge")
            buf = sched.buffers[bname]
            dup_bytes = buf.bytes * skew
            if dup_bytes <= onchip_budget_bytes:
                _duplicate_chain(rs, src, dst, bname, skew, stats)
            else:
                _soft_fifo(rs, src, dst, bname, skew, stats)
    return stats


def _duplicate_chain(rs: ScheduleRewriteSession, src: str, dst: str,
                     bname: str, skew: int, stats: BalanceStats) -> None:
    """Fig. 8(b): chain of copy nodes along the short path."""
    sched = rs.sched
    base = sched.buffers[bname]
    cur = bname
    for level in range(skew):
        dup = fresh_name(f"{bname}_skid")
        rs.add_buffer(Buffer(
            name=dup, shape=base.shape, dtype=base.dtype, dims=base.dims,
            stages=2, placement=base.placement))
        copy_node = Node(
            name=fresh_name(f"balance_copy_{bname}"),
            args={cur: MemoryEffect.READ, dup: MemoryEffect.WRITE},
            body=[make_copy_op(base, cur, dup)])
        # Place right before the consumer so topo depth lands mid-path.
        rs.add_node(copy_node, index=rs.position(sched.node(dst)))
        cur = dup
        stats.copy_nodes += 1
    consumer = sched.node(dst)
    # Consumer now reads the deepest duplicate.
    rs.rename_arg(consumer, bname, cur)
    stats.log.append(f"dup-chain {bname} x{skew} for {src}->{dst}")


def _soft_fifo(rs: ScheduleRewriteSession, src: str, dst: str,
               bname: str, skew: int, stats: BalanceStats) -> None:
    """Fig. 8(c): rotate access into an external soft FIFO, ordering kept
    by explicit tokens (elastic node execution)."""
    # One buffer can carry several skewed edges (a fan-out feeding
    # consumers at different depths); the FIFO must be as deep as the
    # *deepest* edge demands.  The edges iterate in name order, not skew
    # order, so a later smaller-skew edge must not shrink stages below
    # an earlier edge's skew+1 requirement.
    cur = rs.sched.buffers[bname].stages
    rs.set_buffer_attrs(bname, stages=max(cur, skew + 1),
                        placement="external")
    rs.add_token(src, dst)
    stats.soft_fifos += 1
    stats.log.append(
        f"soft-fifo {bname} stages={rs.sched.buffers[bname].stages} "
        f"token {src}->{dst}")
