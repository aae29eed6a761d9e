"""ShardingPlan: the artifact HIDA-OPT hands to the model.

A copy of the reference's ``repro.core.plan`` without JAX.  The data half
(``rules``, ``buffer_specs``, ``meta``, ``role_sources``, the JSON format,
the delta re-projection, ``build_plan`` / ``project_rules``) is the
reference's, line for line.  Specs are plain tuples whose entries equal
those of the reference's ``PartitionSpec`` (``None``, an axis name, or a
tuple of names).  On a ``torch.distributed`` ``DeviceMesh`` a spec
becomes DTensor placements in JAX's order (:func:`placements`), and
:meth:`ShardingPlan.named_sharding` pairs the mesh with them, as the
reference's ``NamedSharding`` does.  :meth:`ShardingPlan.constrain`
redistributes a ``DTensor`` under the ambient mesh (``set_mesh`` in
``repro_torch.launch.mesh``) and returns anything else as it is, as the
reference's does outside a mesh context.

Under a mesh the model meets DTensors where the reference's partitioner
works on its own.  :func:`project` runs a weight product on each
rank's blocks as that partitioner runs a dot, the weight laid out only
as far as the product needs; :func:`logsumexp_and_take` reduces a
vocab-split loss where it lies; :func:`relayout` does at a site what
the partitioner does there (a layer's other weights gathered at their
use, a dim made whole or mergeable, an output laid out as the residual
it joins); :func:`layer_of` and :func:`lookup` are the indexing operations
DTensor lays out badly or not at all, and
:func:`local` the block an elementwise update runs on.  Without an
ambient mesh each returns at once: ``x``, or the plain operation.

``build_plan`` converts a parallelized Structural schedule into:

* ``buffer_specs`` — per Structural buffer, the mesh axes sharding each
  tensor dimension (derived from the owning node's ``axis_map`` through its
  access map).  Model code applies these at the corresponding
  ``with_sharding_constraint`` sites (the TPU realisation of HIDA's buffer
  partition attributes).
* ``rules`` — logical-dim-name → mesh axes, the majority assignment across
  nodes; used for tensors that are not first-class Structural buffers
  (optimizer state, RNG keys, …).
* ``fsdp`` — optional ZeRO-3-style extra sharding of weight buffers over
  the unused data axes (beyond-paper feature required to fit the 100B+
  configs in HBM; recorded separately in EXPERIMENTS.md).

The plan is pure data (JSON-serialisable via ``to_json``) so dry-run
artifacts can be diffed across perf iterations.
"""
from __future__ import annotations

import functools
import json
import logging
from collections import Counter
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .estimator import MeshSpec
from .faults import fault_point
from .ir import Schedule, ScheduleTopology

logger = logging.getLogger(__name__)

Axes = tuple[str, ...]
#: A partition spec: per tensor dim ``None``, one mesh axis name, or a
#: tuple of names; trailing ``None`` entries dropped (``tuple(P)`` of the
#: reference's ``PartitionSpec``).
Spec = tuple

#: Serialization format version written by :meth:`ShardingPlan.to_json`
#: and required (exactly) by :meth:`ShardingPlan.from_json`.  Bump it
#: whenever the JSON schema or the semantics of any field change — the
#: persistent plan cache (:mod:`repro_torch.core.plan_cache`) rejects entries
#: whose version differs instead of misapplying a stale layout.
PLAN_FORMAT_VERSION = 1

#: The ambient ``DeviceMesh`` stack that ``launch.mesh.set_mesh`` pushes
#: and pops; :meth:`ShardingPlan.constrain` reads its top.
_MESHES: list = []


def ambient_mesh():
    """The innermost ``set_mesh`` mesh, or ``None`` outside one."""
    return _MESHES[-1] if _MESHES else None


def relayout(x, how: str, *args):
    """At one site of the model, what the reference's partitioner does
    there on its own, done by hand for DTensors under the ambient mesh.
    Without a mesh ``x`` comes back at once (no import, no work), and so
    does a plain tensor.  ``how`` and its arguments:

    * ``"gathered"`` (``skip=()``): ``x`` a tensor or a dict of them,
      every DTensor leaf replicated over its mesh except the keys named
      in ``skip``: a layer's weights all-gathered at their use, as the
      reference gathers FSDP-sharded weights inside the layer;
    * ``"whole"`` (``dim``): tensor dim ``dim`` unsharded, the other
      placements kept: the gather an operation along it needs;
    * ``"mergeable"`` (``start, end``): dims ``start`` to ``end`` ready to
      be merged by a reshape: the later dims whole, the first one split
      only where the split is even (DTensor cannot merge a split of the
      later ones; GSPMD pads and strides);
    * ``"like"`` (``other``): laid out as the DTensor ``other`` before
      the two meet in an elementwise operation, so that the gradient
      flowing back into ``x`` takes ``x``'s own layout again (a layer's
      output joins the residual so, as sequence parallelism cuts it
      back).
    """
    if not _MESHES:
        return x
    return _RELAYOUTS[how](x, *args)


def _gathered(tree, skip: tuple[str, ...] = ()):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(tree, dict):
        return {k: v if k in skip else _gathered(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.redistribute(
            tree.device_mesh, [Replicate()] * tree.device_mesh.ndim)
    return tree


def _whole(x, dim: int):
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = [Replicate() if getattr(p, "dim", None) == dim else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(
        x.device_mesh, want)


def _mergeable(x, start: int, end: int):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    start, end = start % x.ndim, end % x.ndim
    for d in range(start + 1, end + 1):
        x = _whole(x, d)
    n = 1
    for i, p in enumerate(x.placements):
        if getattr(p, "dim", None) == start:
            n *= x.device_mesh.size(i)
    return x if x.shape[start] % n == 0 else _whole(x, start)


def _like(x, other):
    from torch.distributed.tensor import DTensor
    if (isinstance(x, DTensor) and isinstance(other, DTensor)
            and x.placements != other.placements):
        return x.redistribute(other.device_mesh, other.placements)
    return x


_RELAYOUTS = {"gathered": _gathered, "whole": _whole,
              "mergeable": _mergeable, "like": _like}


def local(t):
    """This rank's block of a DTensor under the ambient mesh (a pending
    sum reduced first), differentiably; anything else as it is.  An
    elementwise update of sharded params runs on these blocks."""
    if not _MESHES:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    if any(p.is_partial() for p in t.placements):
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t.to_local()


def layer_of(t, i: int):
    """Layer ``i`` of a stacked leaf ``t`` (``t[i]``).  Under a mesh, a
    DTensor whose stacked dim is whole is sliced on each rank's shard,
    its placements moved down one dim: DTensor's own ``select`` mislays a
    ``_StridedShard`` (``placements``) in some torch versions."""
    if not _MESHES:
        return t[i]
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if not isinstance(t, DTensor) or any(
            getattr(p, "dim", None) == 0 for p in t.placements):
        return t[i]
    moved = [_StridedShard(p.dim - 1, split_factor=p.split_factor)
             if isinstance(p, _StridedShard)
             else Shard(p.dim - 1) if isinstance(p, Shard) else p
             for p in t.placements]
    shape = tuple(t.shape[1:])
    return DTensor.from_local(t.to_local()[i], t.device_mesh, moved,
                              run_check=False, shape=shape,
                              stride=_contiguous(shape))


def lookup(table, ids):
    """Rows ``ids`` of the embedding ``table`` (``table[ids]``).  Under a
    mesh a DTensor table is gathered and looked up by ``F.embedding``,
    whose gradient DTensor lays out (it has no strategy for the scatter
    that indexing's gradient is)."""
    if not _MESHES:
        return table[ids]
    from torch.distributed.tensor import DTensor
    from torch.nn.functional import embedding
    table = _gathered(table)
    if isinstance(table, DTensor):
        return embedding(ids, table)
    return table[ids]


def _take(x, idx):
    """``x.gather(-1, idx)``; for a DTensor ``x`` whose last dim is whole,
    ``idx`` laid out as ``x`` and the gather run on each rank's blocks
    (DTensor's own gather has a gradient, ``new_zeros`` + ``scatter_add``,
    laid out replicated: the global batch's whole ``x`` on every rank)."""
    if not _MESHES:
        return x.gather(-1, idx)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.gather(-1, idx)
    out = x.to_local().gather(-1, _like_on(idx, x).to_local())
    shape = tuple(idx.shape)
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=_contiguous(shape))


def project(x, w, k: int = 1, constrain=None, dims=None, site=None):
    """``x @ w`` over ``x``'s last ``k`` dims and ``w``'s first ``k``,
    shaped ``x.shape[:-k] + w.shape[k:]``, then, given ``constrain``,
    ``constrain(out, dims, site)``.  Without a mesh, the plain product.

    Under a mesh, with ``x`` or ``w`` a DTensor, the product runs on each
    rank's blocks as the reference's partitioner runs a dot: a mesh dim
    that splits a leading dim of ``x`` splits the output the same way
    (``w`` whole there, its gradient a pending sum); one that splits a
    contracted dim splits ``w``'s matching dim alike (the output a
    pending sum); one that leaves ``x`` whole splits ``w``'s output dim
    where the site's layout (``constrain`` being a plan's) splits it
    there, else leaves both whole.  So ``w`` is gathered only as far as
    that, and no product is merged over a split dim or made whole."""
    if _MESHES:
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor) or isinstance(w, DTensor):
            out = _project_blocks(x, w, k, _site_placements(
                constrain, dims, site))
            return out if constrain is None else constrain(out, dims, site)
    lead = tuple(x.shape[:-k])
    if k > 1:
        x = x.reshape(*lead, -1)
    tail = tuple(w.shape[k:])
    if w.ndim != 2 or k != 1:
        w = w.reshape(-1, _prod(tail))
    out = x @ w
    if len(tail) != 1:
        out = out.reshape(*lead, *tail)
    return out if constrain is None else constrain(out, dims, site)


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _site_placements(constrain, dims, site):
    """The placements ``constrain`` gives at ``site`` on the ambient
    mesh, where it is a plan's bound ``constrain``; else ``None``."""
    plan = getattr(constrain, "__self__", None)
    if not isinstance(plan, ShardingPlan) or dims is None:
        return None
    return placements(ambient_mesh(), plan.spec_for_dims(dims, site))


def _project_blocks(x, w, k: int, target):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ambient_mesh()
    whole = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, whole, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, whole, run_check=False)
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    lead = x.ndim - k
    x_grad, w_at, w_grad, out_at = [], [], [], []
    for i, p in enumerate(x.placements):
        d = getattr(p, "dim", None)
        t = target[i] if target is not None else None
        if d is not None and d < lead:
            # a leading dim split: the output split alike
            x_grad.append(p)
            w_at.append(Replicate())
            w_grad.append(Partial())
            out_at.append(p)
        elif d is not None:
            # a contracted dim split: w's matching dim split alike
            wp = _moved_to(p, d - lead)
            x_grad.append(p)
            w_at.append(wp)
            w_grad.append(wp)
            out_at.append(Partial())
        elif type(t) is Shard and t.dim >= lead:
            # x whole here: w's output dim split as the site's
            wp = Shard(t.dim - lead + k)
            x_grad.append(Partial())
            w_at.append(wp)
            w_grad.append(wp)
            out_at.append(t)
        else:
            x_grad.append(Replicate())
            w_at.append(Replicate())
            w_grad.append(Replicate())
            out_at.append(Replicate())
    xl = x.to_local(grad_placements=x_grad)
    wl = w.redistribute(mesh, w_at).to_local(grad_placements=w_grad)
    lead_l = tuple(xl.shape[:lead])
    tail_l = tuple(wl.shape[k:])
    out = xl.reshape(*lead_l, -1) @ wl.reshape(-1, _prod(tail_l))
    out = out.reshape(*lead_l, *tail_l)
    shape = tuple(x.shape[:lead]) + tuple(w.shape[k:])
    return DTensor.from_local(out, mesh, out_at, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def _moved_to(p, dim: int):
    """Placement ``p`` (a ``Shard`` or ``_StridedShard``) on tensor dim
    ``dim``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if isinstance(p, _StridedShard):
        return _StridedShard(dim, split_factor=p.split_factor)
    return Shard(dim)


def attend(fn, q, k, v):
    """``fn(q, k, v, q_offset)``: attention of ``q`` (B, S, H, Dh) over
    ``k`` and ``v``, ``q_offset`` the position of q's first row.  Without
    a mesh, ``fn(q, k, v, 0)``.  Under a mesh, with ``q`` a DTensor split
    only on batch and seq (seq by one mesh dim), on each rank's blocks:
    ``k`` and ``v`` split on batch as ``q`` and whole on seq (a split
    sequence's keys gathered, as the reference's partitioner gathers
    them), ``fn`` given the rank's first row as ``q_offset``, the output
    laid out as ``q``; otherwise ``fn`` on the DTensors."""
    if _MESHES:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if isinstance(q, DTensor):
            dims = [getattr(p, "dim", None) for p in q.placements]
            if (all(type(p) in (Shard, Replicate) for p in q.placements)
                    and set(dims) <= {None, 0, 1} and dims.count(1) <= 1):
                return _attend_blocks(fn, q, k, v)
    return fn(q, k, v, 0)


def _attend_blocks(fn, q, k, v):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = q.device_mesh
    kv_at, kv_grad, off = [], [], 0
    for i, p in enumerate(q.placements):
        d = getattr(p, "dim", None)
        kv_at.append(p if d == 0 else Replicate())
        # every row of a seq block reads all keys: their gradients sum
        kv_grad.append(p if d == 0 else Partial() if d == 1 else Replicate())
        if d == 1:
            off = mesh.get_local_rank(i) * -(-q.shape[1] // mesh.size(i))

    def block(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, kv_at).to_local(grad_placements=kv_grad)
    out = fn(q.to_local(), block(k), block(v), off)
    shape = tuple(q.shape[:2]) + tuple(out.shape[2:])
    return DTensor.from_local(out, mesh, q.placements, run_check=False,
                              shape=shape, stride=_contiguous(shape))


def logsumexp_and_take(x, idx):
    """``(lse, gold)`` over ``x``'s last dim: the stable logsumexp (its
    max taken without a gradient, as the reference's ``stop_gradient``)
    and ``x.gather(-1, idx)[..., 0]``.  Under a mesh, where one mesh dim
    of size > 1 splits the last dim of a DTensor ``x``, both are taken on
    each rank's block and reduced over that dim (``_vocab_split``): the
    reference's partitioner reduces a vocab-sharded loss so, where
    DTensor would gather the vocab, and twice more in the gradient."""
    if _MESHES:
        from torch.distributed.tensor import DTensor, Shard
        if isinstance(x, DTensor):
            last = x.ndim - 1
            cut = [i for i, p in enumerate(x.placements)
                   if getattr(p, "dim", None) == last]
            if (len(cut) == 1 and type(x.placements[cut[0]]) is Shard
                    and x.device_mesh.size(cut[0]) > 1):
                return _vocab_split(x, idx, cut[0])
            x = _whole(x, last)
    m = x.amax(dim=-1, keepdim=True).detach()
    lse = x.sub(m).exp().sum(dim=-1).log() + m[..., 0]
    return lse, _take(x, idx)[..., 0]


def _like_on(idx, x):
    """``idx`` as a DTensor laid out as ``x``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(idx, DTensor):
        return idx.redistribute(x.device_mesh, x.placements)
    return distribute_tensor(idx, x.device_mesh, x.placements)


def _vocab_split(x, idx, i: int):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    # idx: whole on the vocab's mesh dim, split as x on the others
    keep = [Replicate() if j == i else p for j, p in enumerate(x.placements)]
    idx = _like_on(idx, x).redistribute(mesh, keep)
    # Shard's blocks are torch.chunk's: ceil(V / n) each, the last short
    lo = mesh.get_local_rank(i) * -(-x.shape[-1] // mesh.size(i))
    lse, gold = _vocab_split_fn().apply(x.to_local(), idx.to_local(), lo,
                                        mesh.get_group(i))
    out = [Replicate() if j == i else p for j, p in enumerate(keep)]
    shape = tuple(x.shape[:-1])
    return tuple(DTensor.from_local(t, mesh, out, run_check=False,
                                    shape=shape, stride=_contiguous(shape))
                 for t in (lse, gold))


@functools.cache
def _vocab_split_fn():
    """The autograd ``Function`` of :func:`_vocab_split`, built at its
    first use (this module imports no torch)."""
    import torch
    import torch.distributed as dist

    class VocabSplit(torch.autograd.Function):
        """``(lse, gold)`` of a block ``xl`` of the last dim (its first
        column ``lo``), max, sums and gold all-reduced over ``group``;
        the gradient in autograd's own order of the plain form."""

        @staticmethod
        def forward(ctx, xl, il, lo, group):
            m = xl.amax(dim=-1, keepdim=True)
            dist.all_reduce(m, dist.ReduceOp.MAX, group=group)
            e = xl.sub(m).exp()
            s = e.sum(dim=-1)
            dist.all_reduce(s, group=group)
            j = il - lo
            hit = (j >= 0) & (j < xl.shape[-1])
            j = j.clamp(0, max(xl.shape[-1] - 1, 0))
            gold = torch.where(hit, xl.gather(-1, j), 0)[..., 0]
            dist.all_reduce(gold, group=group)
            ctx.save_for_backward(e, s, j, hit)
            return s.log() + m[..., 0], gold

        @staticmethod
        def backward(ctx, g_lse, g_gold):
            e, s, j, hit = ctx.saved_tensors
            gx = (g_lse / s)[..., None] * e
            gx = gx + torch.zeros_like(e).scatter_add(
                -1, j, torch.where(hit, g_gold[..., None], 0))
            return gx, None, None, None
    return VocabSplit


def _contiguous(shape) -> tuple:
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def _spec_axes(entry) -> Axes:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements, one per mesh dim, that lay a tensor out as
    the reference's ``NamedSharding(mesh, PartitionSpec(*spec))`` does.

    Where one tensor dim carries several mesh axes, JAX reads them in the
    spec's order, the first named the major one.  DTensor nests
    ``Shard`` placements in mesh-dim order instead, so an axis that the
    spec names after an axis of a later mesh dim takes a
    ``_StridedShard`` whose split factor is the product of those earlier-
    named, later-mesh-dim axes: on a ``("data", "model")`` mesh the spec
    ``(("model", "data"),)`` is ``[_StridedShard(0, split_factor=|model|),
    Shard(0)]``.  This is the one place that uses the private
    ``_StridedShard``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for tdim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        for i, axis in enumerate(axes):
            m = names.index(axis)
            split = 1
            for major in axes[:i]:
                if names.index(major) > m:
                    split *= mesh.size(names.index(major))
            out[m] = (Shard(tdim) if split == 1
                      else _StridedShard(tdim, split_factor=split))
    return tuple(out)


def check_layout(mesh, spec: Spec, shape: Sequence[int]) -> None:
    """Raise where DTensor cannot hold JAX's layout of ``shape``.  JAX
    cuts a dim into ceil-sized shards, the last short or empty, over the
    product of its axes; DTensor's ``Shard`` cuts the same way for one
    axis, but nests its cuts for several, which differs as soon as the
    product does not divide the dim."""
    names = tuple(mesh.mesh_dim_names)
    for tdim, entry in enumerate(spec):
        axes = _spec_axes(entry)
        if len(axes) < 2:
            continue
        n = 1
        for axis in axes:
            n *= mesh.size(names.index(axis))
        if shape[tdim] % n:
            raise ValueError(
                f"dim {tdim} of size {shape[tdim]} is sharded over "
                f"{axes} ({n} shards): uneven over several mesh axes, "
                "which DTensor cannot lay out as JAX does")


@dataclass(frozen=True)
class NamedSharding:
    """The mesh, the reference's spec and the DTensor placements that lay
    it out: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: Spec
    placements: tuple

    def distribute(self, x):
        """``x``, the full tensor (rank 0's), as a DTensor of this layout:
        each rank keeps its shard."""
        from torch.distributed.tensor import distribute_tensor
        check_layout(self.mesh, self.spec, x.shape)
        return distribute_tensor(x, self.mesh, list(self.placements))


@dataclass
class ShardingPlan:
    mesh_spec: MeshSpec
    buffer_specs: dict[str, tuple[Axes, ...]] = field(default_factory=dict)
    rules: dict[str, Axes] = field(default_factory=dict)
    fsdp: bool = False
    meta: dict = field(default_factory=dict)
    #: role alias -> source buffer site (e.g. ``"qkv" -> "L0__qkv"``); the
    #: alias's spec in ``buffer_specs`` mirrors the source's and is kept in
    #: step by :meth:`apply_rule_change`.  Derivable from the names, so it
    #: is not serialized.
    role_sources: dict[str, str] = field(default_factory=dict)
    #: site -> count of overrides dropped by :meth:`spec_for_dims` because
    #: the stored per-dim rank mismatched the queried dims.  A diagnostic
    #: populated on the query path, so kept out of ``meta`` / ``to_json``
    #: — the serialized plan stays pure data, independent of query history.
    spec_rank_mismatches: dict[str, int] = field(default_factory=dict)

    # -- spec construction ---------------------------------------------------
    def _dedupe(self, axes_per_dim: Sequence[Axes]) -> tuple:
        """PartitionSpec axes must be unique; first use (leftmost dim) wins,
        later dims drop the duplicate axis (replicate instead)."""
        used: set[str] = set()
        out = []
        for axes in axes_per_dim:
            keep = tuple(a for a in axes if a not in used)
            used.update(keep)
            if not keep:
                out.append(None)
            elif len(keep) == 1:
                out.append(keep[0])
            else:
                out.append(keep)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def spec_for_dims(self, dims: Sequence[str],
                      site: str | None = None) -> Spec:
        """PartitionSpec for a tensor described by logical dim names,
        honouring a buffer-site override when given.  A site override
        whose stored rank mismatches ``dims`` (common for role aliases
        stripped from layer-prefixed names) falls back to the rules — the
        drop is counted in :attr:`spec_rank_mismatches` (and debug-logged)
        so silently replicated tensors are diagnosable."""
        if site is not None and site in self.buffer_specs:
            per_dim = self.buffer_specs[site]
            if len(per_dim) == len(dims):
                return self._dedupe(per_dim)
            mm = self.spec_rank_mismatches
            mm[site] = mm.get(site, 0) + 1
            logger.debug(
                "spec_for_dims: site %r override rank %d != dims %r; "
                "falling back to rules", site, len(per_dim), tuple(dims))
        per_dim = [self.rules.get(d, ()) for d in dims]
        return self._dedupe(per_dim)

    def param_spec(self, dims: Sequence[str], site: str | None = None,
                   shape: Sequence[int] | None = None) -> Spec:
        """Weight spec; with ``fsdp`` the unused data axes additionally
        shard a remaining dim (ZeRO-3), preferring evenly divisible dims
        when the shape is known (avoids GSPMD padding waste)."""
        base = self.spec_for_dims(dims, site)
        # Expert weights are fully sharded by expert (EP widened over the
        # data axis for big expert counts) — extra FSDP axes on their
        # other dims would force per-layer gathers that XLA hoists out of
        # the layer scan into a stacked multi-hundred-GiB temp.
        if not self.fsdp or "experts" in dims:
            return base
        spec = list(base) + [None] * (len(dims) - len(base))
        used = {a for entry in spec if entry
                for a in ((entry,) if isinstance(entry, str) else entry)}

        def place(axis_name: str, i: int) -> None:
            entry = spec[i]
            if entry is None:
                spec[i] = axis_name
            else:
                cur = (entry,) if isinstance(entry, str) else tuple(entry)
                spec[i] = cur + (axis_name,)
            used.add(axis_name)

        for axis_name in ("data", "pod"):
            try:
                size = self.mesh_spec.size(axis_name)
            except KeyError:
                continue
            if axis_name in used:
                continue
            candidates = [i for i, e in enumerate(spec) if e is None]
            candidates += [i for i in range(len(spec))
                           if i not in candidates]
            if shape is not None:
                # The composed factor (existing axes × fsdp axis) must
                # divide the dim — jit argument shardings reject padding.
                def factor(i):
                    e = spec[i]
                    f = size
                    for a in ((e,) if isinstance(e, str) else (e or ())):
                        f *= self.mesh_spec.size(a)
                    return f
                candidates = [i for i in candidates
                              if shape[i] % factor(i) == 0]
            if candidates:
                place(axis_name, candidates[0])
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    # -- application ----------------------------------------------------------
    def constrain(self, x, dims: Sequence[str], site: str | None = None):
        """Apply a sharding constraint at a Structural buffer site: under
        an ambient mesh (``launch.mesh.set_mesh``) a ``DTensor`` is
        redistributed to the site's placements.  A plain tensor, or any
        tensor outside a mesh, is returned as it is, as the reference's
        constraint is a no-op outside a mesh context."""
        mesh = ambient_mesh()
        if mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        spec = self.spec_for_dims(dims, site)
        check_layout(mesh, spec, x.shape)
        return x.redistribute(mesh, placements(mesh, spec))

    def named_sharding(self, mesh, dims: Sequence[str],
                       site: str | None = None, weight: bool = False,
                       shape: Sequence[int] | None = None) -> NamedSharding:
        """The layout of a tensor of logical ``dims`` on ``mesh``: the
        weight spec (``param_spec``, FSDP included) or the buffer spec,
        as the reference's ``named_sharding``."""
        spec = (self.param_spec(dims, site, shape) if weight
                else self.spec_for_dims(dims, site))
        return NamedSharding(mesh, spec, placements(mesh, spec))

    # -- incremental re-projection --------------------------------------------
    def add_role_alias(self, role: str, source: str) -> None:
        """Expose ``source``'s spec under the stripped role name (first
        writer wins, matching ``setdefault``); the alias tracks its source
        through later :meth:`apply_rule_change` re-projections."""
        if role in self.buffer_specs or source not in self.buffer_specs:
            return
        self.buffer_specs[role] = self.buffer_specs[source]
        self.role_sources[role] = source

    def apply_rule_change(self, dim: str, axes: Axes,
                          sched: Schedule,
                          topology: ScheduleTopology | None = None
                          ) -> list[str]:
        """Delta re-projection: set ``rules[dim] = axes`` (empty ``axes``
        deletes the rule) and re-project **only** the buffer sites whose
        coherent access maps reference ``dim`` — plus their role aliases —
        instead of rebuilding every spec like :func:`project_rules`.

        Requires the plan to be coherent (every site already the
        projection of the current rules, i.e. built with
        ``coherent=True`` and mutated only through this method); then the
        result is bit-identical to a full :func:`project_rules` rebuild
        under the new rules.  Returns the re-projected site names."""
        fault_point("plan.delta")
        if axes:
            self.rules[dim] = tuple(axes)
        else:
            self.rules.pop(dim, None)
        topo = topology or sched.topology()
        changed: list[str] = []
        for bname in topo.buffers_of_dim.get(dim, ()):
            if bname not in self.buffer_specs:
                continue
            per_dim = _projected_spec(self.rules, topo.axis_dims[bname])
            self.buffer_specs[bname] = per_dim
            buf = sched.buffers.get(bname)
            if buf is not None:
                buf.spec = per_dim
            changed.append(bname)
        touched = set(changed)
        for role, source in self.role_sources.items():
            if source in touched:
                self.buffer_specs[role] = self.buffer_specs[source]
                changed.append(role)
        return changed

    # -- serialisation ----------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "version": PLAN_FORMAT_VERSION,
            "mesh": [[a, int(s)] for a, s in self.mesh_spec.axes],
            "buffer_specs": {k: [list(a) for a in v]
                             for k, v in self.buffer_specs.items()},
            "rules": {k: list(v) for k, v in self.rules.items()},
            "fsdp": self.fsdp,
            "meta": self.meta,
            # Role aliases are derivable from the "__"-prefixed names on a
            # live plan, but a deserialized plan must re-project aliases
            # through apply_rule_change without re-deriving, so the map is
            # carried explicitly (round-trip exactness > redundancy).
            "role_sources": dict(self.role_sources),
            # sort_keys makes the serialization canonical: two plans with
            # equal content serialize to the same bytes regardless of the
            # insertion order their dicts were built in — the round trip
            # from_json(to_json(p)).to_json() is bit-identical, and plan
            # JSON is directly comparable/hashable by the cache layer.
        }, indent=2, sort_keys=True, default=str)

    @classmethod
    def from_json(cls, text: str) -> "ShardingPlan":
        """Exact inverse of :meth:`to_json`: the round trip
        ``ShardingPlan.from_json(p.to_json()).to_json() == p.to_json()``
        is bit-identical, including role aliases and ``meta``.

        Raises ``ValueError`` when the serialized ``version`` is not
        :data:`PLAN_FORMAT_VERSION` — a stale persisted plan must be
        rejected (and re-derived), never silently misapplied."""
        d = json.loads(text)
        version = d.get("version")
        if version != PLAN_FORMAT_VERSION:
            raise ValueError(
                f"plan format version {version!r} != supported "
                f"{PLAN_FORMAT_VERSION}; stale entry must be re-derived")
        return cls(
            mesh_spec=MeshSpec(tuple((a, int(s)) for a, s in d["mesh"])),
            buffer_specs={k: tuple(tuple(a) for a in v)
                          for k, v in d["buffer_specs"].items()},
            rules={k: tuple(v) for k, v in d["rules"].items()},
            fsdp=bool(d["fsdp"]),
            meta=d["meta"],
            role_sources=dict(d.get("role_sources", {})))


def replicated_plan(mesh_spec: MeshSpec, data_axes: Axes = ("pod", "data"),
                    fsdp: bool = False) -> ShardingPlan:
    """The naive baseline: batch over data axes, everything else
    replicated (what you get without the paper's technique)."""
    rules = {"batch": tuple(a for a in data_axes
                            if a in mesh_spec.names)}
    return ShardingPlan(mesh_spec=mesh_spec, rules=rules, fsdp=fsdp,
                        meta={"strategy": "naive-dp"})


def _projected_spec(rules: dict[str, Axes],
                    axis_dims: Sequence[Optional[str]]) -> tuple[Axes, ...]:
    """THE projection routine: per-buffer spec as the consensus rules seen
    through the buffer's coherent per-axis loop dims (first non-None dim
    any owner's access map names at each axis — see
    ``ScheduleTopology.axis_dims``).  Both the full rebuild
    (:func:`project_rules`) and the delta path
    (:meth:`ShardingPlan.apply_rule_change`) go through here, so they
    cannot diverge.  Scanning *all* owners per axis (not just the first
    owner with any access map) is what fixes the silent-unshard hazard:
    a producer whose access map has ``None`` at an axis no longer hides a
    consumer's loop dim there."""
    return tuple(rules.get(d, ()) if d else () for d in axis_dims)


def build_plan(sched: Schedule, mesh_spec: MeshSpec,
               fsdp: bool = False, meta: dict | None = None,
               coherent: bool = True,
               topology: ScheduleTopology | None = None) -> ShardingPlan:
    """Derive the :class:`ShardingPlan` from a parallelized schedule.

    Runs after the DSE (greedy + beam search, see
    :func:`repro_torch.core.parallelize.parallelize`) has written ``unroll`` /
    ``axis_map`` onto every node: per-buffer specs come from the owning
    nodes' axis maps projected through their access maps; per-logical-dim
    ``rules`` are the intensity-weighted majority vote across nodes.

    Args:
        sched: parallelized Structural schedule (read-only here).
        mesh_spec: target mesh (recorded in the plan for ``specs()``).
        fsdp: ZeRO-3-style extra weight sharding over unused data axes
            (beyond-paper; needed to fit the 100B+ configs in HBM).
        meta: free-form provenance recorded in the plan (JSON-serialised
            with it).
        coherent: ``True`` (the CA-on product) projects one
            intensity-weighted consensus rule per logical dim onto every
            buffer site — constraint sites never disagree, so GSPMD
            resharding stays incremental.  ``False`` keeps raw per-node
            layouts (the CA-off ablation arm); measured on deepseek-v3
            train_4k this triggers GSPMD "involuntary full
            rematerialization" and ~2.3 TiB/device of temp — the TPU
            incarnation of the paper's Fig. 11 'flawed designs'.
        topology: the shared :class:`ScheduleTopology`; defaults to the
            schedule's cached one (the same structure the incremental
            estimator's DSE ran on).
    """
    fault_point("plan.build")
    plan = ShardingPlan(mesh_spec=mesh_spec, fsdp=fsdp, meta=meta or {})
    topo = topology or sched.topology()

    votes: dict[str, Counter] = {}
    for bname, buf in sched.buffers.items():
        if not topo.owners(bname):
            continue
        per_dim: list[Axes] = []
        for pairs in topo.axis_owner_dims[bname]:
            axes: Axes = ()
            # Producer's layout wins; an unparallelized producer (e.g. the
            # amortized embed node, pf=1) defers to its consumers so the
            # buffer does not force a reshard at every layer boundary.
            for node, d in pairs:
                a = tuple(node.axis_map.get(d, ()))
                if a:
                    axes = a
                    break
            per_dim.append(axes)
            if pairs:
                votes.setdefault(pairs[0][1], Counter())[axes] += 1
        plan.buffer_specs[bname] = tuple(per_dim)
        buf.spec = tuple(per_dim)

    for node in sched.nodes:
        # Intensity-weighted votes: the critical nodes decide the rules.
        w = max(int(node.intensity() ** 0.5), 1)
        for dim, axes in node.axis_map.items():
            votes.setdefault(dim, Counter())[tuple(axes)] += w

    for dim, counter in votes.items():
        winner, _ = counter.most_common(1)[0]
        if winner:
            plan.rules[dim] = winner

    if coherent:
        project_rules(plan, sched, topology=topo)
    return plan


def project_rules(plan: ShardingPlan, sched: Schedule,
                  topology: ScheduleTopology | None = None) -> None:
    """Rewrite every buffer site as the projection of the consensus rules
    — one layout basin across the whole dataflow.  This is the full
    rebuild; :meth:`ShardingPlan.apply_rule_change` is the O(Δ) path for
    a single-rule update.  Both run the same projection
    (:func:`_projected_spec`) over the same cached per-axis dims, so a
    delta-maintained plan and a from-scratch rebuild are bit-identical."""
    fault_point("plan.project")
    topo = topology or sched.topology()
    for bname, buf in sched.buffers.items():
        if bname not in plan.buffer_specs:
            continue
        per_dim = _projected_spec(plan.rules, topo.axis_dims[bname])
        plan.buffer_specs[bname] = per_dim
        buf.spec = per_dim
    for role, source in plan.role_sources.items():
        if source in plan.buffer_specs:
            plan.buffer_specs[role] = plan.buffer_specs[source]
