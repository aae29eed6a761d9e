"""Collective-byte and operation accounting of one step: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference compiles its step and parses the per-device HLO for
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute.  The port has no HLO: :class:`StepCounter` is a
``TorchDispatchMode`` that sees the collectives a step issues as it runs
(on fake tensors over a fake process group in the dry-run,
``launch/dryrun.py``), the c10d and functional-collective operations
alike:

==============================  ==================
port operation                  counted as
==============================  ==================
``all_gather_into_tensor``      all-gather
``all_reduce``                  all-reduce
``reduce_scatter_tensor``       reduce-scatter
``all_to_all_single``           all-to-all
send / recv                     collective-permute
==============================  ==================

Bytes are counted as the reference counts them: those of each
collective's result on this rank (a receive's buffer for a transfer; its
send is the other half of the peer's receive and is not counted again).
Other c10d operations (broadcast, scatter, barrier) are counted under
their own names, so that none goes unseen.  The port runs its layers
unrolled, so every collective is seen on each pass: the loop-resident
totals are empty and ``loop_trip`` is 1.

The mode hands every operation on DTensors back to DTensor, which
lowers it to this rank's operations on its shards and the collectives
it needs; the mode counts those, so it sees this rank's program, as the
reference reads its per-device HLO.  It counts that program's
floating-point operations with ``torch.utils.flop_counter``'s formulas,
and ``op_histogram`` counts its aten operations, in place of the
reference's ``hlo_op_histogram``.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

#: operation name (without its namespace and overload) -> kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}
#: namespaces of the collective operations
_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
#: operations that move nothing of their own (a send is its peer's recv)
_SILENT = ("wait_tensor", "send", "monitored_barrier_")
#: c10d operations that write their first argument from their second
_OUT_IN = ("allgather_", "_allgather_base_",
           "allgather_into_tensor_coalesced_", "allgather_coalesced_",
           "reduce_scatter_", "_reduce_scatter_base_", "alltoall_",
           "alltoall_base_")


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)
    loop_bytes_by_kind: dict = field(default_factory=dict)

    @property
    def top_bytes(self) -> int:
        return (sum(self.bytes_by_kind.values())
                - sum(self.loop_bytes_by_kind.values()))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def scaled_total(self, loop_trip: int) -> int:
        """Total per-rank bytes with loop-resident collectives scaled by
        the loop's trip count (none here: the layers run unrolled)."""
        return self.top_bytes + loop_trip * sum(
            self.loop_bytes_by_kind.values())

    def add(self, kind: str, nbytes: int) -> None:
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def to_dict(self, loop_trip: int = 1) -> dict:
        return {"bytes_by_kind": self.bytes_by_kind,
                "count_by_kind": self.count_by_kind,
                "loop_bytes_by_kind": self.loop_bytes_by_kind,
                "top_bytes": self.top_bytes,
                "total_bytes": self.total_bytes,
                "loop_trip": loop_trip,
                "scaled_total_bytes": self.scaled_total(loop_trip)}


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def collective_kind(func) -> str | None:
    """The kind of collective ``func`` is (``COLLECTIVE_OPS``, or its own
    name for another c10d operation), or ``None``."""
    ns, _, name = func._schema.name.partition("::")
    if ns not in _NAMESPACES or name in _SILENT:
        return None
    return _KINDS.get(name, name.rstrip("_"))


@contextlib.contextmanager
def shape_propagation_unseen():
    """Inside, DTensor's inference of an operation's global output
    shape (it runs the operation once on fake tensors of the global
    shapes, cached per signature) runs with every dispatch mode set
    aside, so that a counter or memory tracker does not take those
    global-shape tensors, which no rank allocates, for this rank's.
    Without this, one cached propagation of the loss's (B, S, vocab)
    gradient read as 4.8 GB of temp in the reduced smollm cell."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}: "
                           "the dry-run cannot set its shape inference "
                           "apart from the rank's program")

    def unseen(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)
    setattr(ShardingPropagator, name, unseen)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


class StepCounter(TorchDispatchMode):
    """Counts what one rank runs under it: collectives by kind and result
    bytes (``stats``), the bytes of their inputs by kind
    (``operand_bytes``: a reduce-scatter's whole operand, which is what
    an all-reduce in its place would return), FLOPs (``flops``) and aten
    operations (``ops``).
    An operation on DTensors is handed back (``NotImplemented``) so that
    DTensor lowers it to this rank's operations on its shards and the
    collectives it needs, which this mode then sees: the per-rank
    program, as the reference's per-device HLO is."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()
        self.operand_bytes: Counter = Counter()
        self.flops = 0
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func._schema.name.partition("::")[0]
        if ns in _NAMESPACES:
            kind = collective_kind(func)
            if kind is not None:
                # c10d operations write into their first argument (some
                # from their second); the functional ones return their
                # result
                name = func._schema.name.partition("::")[2]
                self.stats.add(kind,
                               _nbytes(args[0] if ns == "c10d" else out))
                self.operand_bytes[kind] += _nbytes(
                    args[1] if name in _OUT_IN else args[0])
            return out
        if ns == "prim":
            return out
        self.ops[str(func.overloadpacket).replace("aten.", "")] += 1
        self.flops += _flops(func, args, kwargs, out)
        return out

    def op_histogram(self, top: int = 20) -> list[tuple[str, int]]:
        return sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]


def _flops(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    formula = flop_registry.get(func.overloadpacket)
    return 0 if formula is None else formula(*args, **kwargs, out_val=out)
