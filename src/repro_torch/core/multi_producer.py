"""Multi-producer elimination — paper Algorithm 3 (Section 6.4.1).

Buffers written by multiple producer nodes serialise the whole dataflow.
Two cases:

* **Internal buffers** (allocated inside the schedule): duplicate the
  buffer per extra producer — chained so each producer owns exactly one
  copy — inserting an explicit ``copy`` at the front of a producer that
  also *reads* the previous contents.  Uses dominated by that producer are
  re-pointed at the duplicate.  (Safe because nothing outside the schedule
  can observe an internal buffer.)

* **External buffers** (schedule arguments): duplication is unsound (an
  external writer could update only the original), so all producers are
  fused into a single node and executed sequentially inside it.

On TPU this pass is what legalises multi-writer streams — KV-cache slot
updates, residual-stream accumulators, microbatch gradient accumulators —
into SSA-friendly single-writer buffers that XLA can donate/alias, instead
of forcing a serialised schedule.

All mutation flows through
:class:`~repro_torch.core.rewrite.ScheduleRewriteSession`: producer lists and
dominated-use sets come from the session's Δ-maintained indices (no
per-buffer node scans), buffer duplication / use re-pointing / copy
insertion / producer fusion are session primitives, and the whole pass is
one transaction — an exception rolls the schedule back to its pre-pass
state.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .faults import fault_point
from .ir import Buffer, MemoryEffect, Node, Schedule, fresh_name
from .rewrite import ScheduleRewriteSession, make_copy_op

__all__ = ["MultiProducerStats", "eliminate_multi_producers", "make_copy_op"]


@dataclass
class MultiProducerStats:
    duplicated: int = 0
    copies: int = 0
    merged: int = 0
    log: list[str] = field(default_factory=list)


def eliminate_multi_producers(sched: Schedule,
                              selfcheck: bool = False) -> MultiProducerStats:
    stats = MultiProducerStats()
    with ScheduleRewriteSession(sched, selfcheck=selfcheck) as rs:
        _eliminate(sched, rs, stats)
    return stats


def _eliminate(sched: Schedule, rs: ScheduleRewriteSession,
               stats: MultiProducerStats) -> None:
    # Paper: producers sorted by SSA dominance — i.e. program order, not
    # buffer-dataflow order (an RW node dominates a later W node even
    # though the buffer edge points the other way).

    # -- case (1): internal buffers → duplication ---------------------------
    for bname in list(sched.internal_buffers()):
        producers = sorted(rs.producers(bname), key=rs.position)
        if len(producers) <= 1:
            continue
        cur = bname
        for p in producers[1:]:
            fault_point("mp.duplicate")
            base = sched.buffers[bname]
            dup_name = fresh_name(f"{bname}_dup")
            rs.add_buffer(Buffer(
                name=dup_name, shape=base.shape, dtype=base.dtype,
                dims=base.dims, stages=base.stages, partition=base.partition,
                tiling=base.tiling, placement=base.placement))
            stats.duplicated += 1
            reads_prev = p.args.get(cur) in (MemoryEffect.READ,
                                             MemoryEffect.READ_WRITE)
            # Re-point every use dominated by p (including p itself).
            rs.replace_uses(cur, dup_name,
                            [u for u in rs.users_in_program_order(cur)
                             if rs.position(p) <= rs.position(u)])
            if reads_prev:
                rs.insert_copy(p, sched.buffers[dup_name], cur, dup_name)
                stats.copies += 1
            stats.log.append(f"dup {cur}->{dup_name} for producer {p.name}")
            cur = dup_name

    # -- case (2): external buffers → producer fusion -----------------------
    for bname in list(sched.external_buffers()):
        producers = sorted(rs.producers(bname), key=rs.position)
        if len(producers) <= 1:
            continue
        fault_point("mp.merge")
        # Body concatenation and effect merging are pass policy; the
        # session owns the structural swap (retire olds + insert merged).
        merged = Node(name=fresh_name("merged_node"))
        for p in producers:
            merged.body.extend(p.body)
            for v, e in p.args.items():
                prev = merged.args.get(v)
                if prev is None:
                    merged.args[v] = e
                elif prev != e:
                    merged.args[v] = MemoryEffect.READ_WRITE
        first_idx = min(rs.position(p) for p in producers)
        rs.replace_nodes(producers, merged, first_idx)
        stats.merged += len(producers)
        stats.log.append(
            f"merged producers {[p.name for p in producers]} of {bname} "
            f"-> {merged.name}")
