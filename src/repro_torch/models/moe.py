"""Mixture-of-Experts FFN on one card: top-k router with z-loss and
load-balance aux loss, sort-based capacity dispatch, expert SwiGLU
products, weighted combine, optional shared experts.

Counterpart of ``repro.models.moe``, with the same parameter paths,
shapes and dtypes.  ``moe_ffn`` routes through the expert-parallel
exchange ``moe_ffn_ep`` where its ``ep`` hint and the mesh allow it, as
the reference does: each rank slots its own tokens per expert group,
an ``all_to_all`` over the expert axes ships them to the experts' owners,
which run them densely, and a second ``all_to_all`` ships the results
home.  The mesh is a ``torch.distributed`` ``DeviceMesh``; the body runs
through ``local_map``, the counterpart of ``shard_map``.

A model served expert-parallel (``LM(experts=ExpertShare(...))``; the
reference has no such path) holds its rank's experts only and takes
``moe_ffn_serve_ep`` in every MoE layer, the decode step's included:
the same dispatch, exchange and expert products, over plain tensors and
a process group, at the single-card capacity rule per source.  Routing
has DeepSeek-V2's group-limited form under ``MoEConfig`` fields whose
defaults keep the reference's (``router_topk``).

Two departures, both where the reference's result is unspecified:

* The dispatch buffer receives the kept (token, k) copies only.  The
  reference scatters every assignment and points the dropped ones at
  slot 0 with a zero row; a scatter with duplicate indices is unspecified
  in XLA (and in ``index_put`` on CUDA), and on the CPU the later zero
  wins, so slot 0 of an expert that overflows comes out zero although
  ``keep`` says its token was kept.  Here a dropped copy goes to one
  scratch row past the buffer, which is then cut off.
* With ``use_kernels`` both expert products run the grouped-matmul kernel
  (``kernels/moe_gmm``) with ``group_sizes = min(count_e, capacity)``
  (``G·cap``, every row, in the expert-parallel body, whose rows from
  different sources are no one live prefix).  Rows past an expert's
  group size are zero in the buffer and so give zero outputs: the same
  function as the reference's einsums, which run without kernels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..configs.base import ArchConfig, MoEConfig
from ..core.plan import ambient_mesh, placements
from .layers import F32, ParamBuilder

Constrain = Callable[..., torch.Tensor]

class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def init_moe(pb: ParamBuilder, path: str, cfg: ArchConfig,
             stack: int | None = None, held: int | None = None,
             generator: torch.Generator | None = None) -> None:
    """The router over all experts; ``held`` experts' matrices (all of
    them by default; a rank's share under expert-parallel serving), drawn
    from ``generator`` where one is given."""
    moe = cfg.moe
    D, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
    El = E if held is None else held
    pb.weight(f"{path}/w_router", (D, E), ("d_model", "experts"),
              dtype=F32, stack=stack)
    pb.weight(f"{path}/w_in", (El, D, 2, Fe),
              ("experts", "d_model", "two", "d_ff"), stack=stack,
              generator=generator)
    pb.weight(f"{path}/w_out", (El, Fe, D),
              ("experts", "d_ff", "d_model"), stack=stack,
              generator=generator)
    if moe.n_shared:
        Fs = moe.n_shared * Fe
        pb.weight(f"{path}/w_shared_in", (D, 2, Fs),
                  ("d_model", "two", "d_ff"), stack=stack)
        pb.weight(f"{path}/w_shared_out", (Fs, D), ("d_ff", "d_model"),
                  stack=stack)


def router_topk(x: torch.Tensor, w_router: torch.Tensor, moe: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor, MoEAux]:
    """(T,D) → gates (T,K), expert ids (T,K), aux losses.

    With ``moe.n_group`` > 1, DeepSeek-V2's group-limited greedy routing
    (its ``group_limited_greedy``): the experts fall in ``n_group``
    groups of consecutive ids, each scored by its best softmax
    probability; a token picks its top ``topk_group`` groups, then its
    top-k experts among theirs.  ``norm_topk`` False leaves the gates
    unnormalised and multiplies them by ``routed_scale``.  The aux losses
    read the unmasked probabilities either way."""
    logits = (x.to(F32) @ w_router).to(F32)               # (T,E)
    probs = torch.softmax(logits, dim=-1)
    E = w_router.shape[-1]
    chosen = probs
    if moe.n_group > 1:
        T = probs.shape[0]
        best = probs.view(T, moe.n_group, -1).amax(-1)     # (T, n_group)
        groups = torch.topk(best, moe.topk_group, dim=-1).indices
        allowed = torch.zeros_like(best, dtype=torch.bool).scatter_(
            1, groups, True)
        chosen = probs.masked_fill(
            ~allowed.repeat_interleave(E // moe.n_group, dim=1), 0.0)
    gate, idx = torch.topk(chosen, moe.top_k, dim=-1)
    if moe.norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    else:
        gate = gate * moe.routed_scale
    # Switch-style load-balance loss + z-loss.
    me = probs.mean(0)
    ce = F.one_hot(idx, E).to(F32).sum(1).mean(0)
    lb = E * torch.sum(me * ce) / moe.top_k
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gate, idx, MoEAux(lb, z, torch.zeros((), device=x.device))


#: the function itself: a replaced ``router_topk`` (a test's or a
#: script's pin of the expert choice) would run only once in a CUDA
#: graph, at capture, so ``launch/graphs.py`` refuses to capture or replay
#: a graph of an MoE model while ``router_topk`` is not this
ROUTER_TOPK = router_topk


def expert_counts(eid: torch.Tensor, E: int) -> torch.Tensor:
    """(N,) expert ids → (E,) int64 copies per expert, empty experts 0:
    ``torch.bincount(eid, minlength=E)`` at a fixed size, without the
    host sync that sizes bincount's output on CUDA (which a CUDA graph
    capture refuses)."""
    return torch.zeros(E, dtype=torch.int64, device=eid.device) \
        .index_add_(0, eid, torch.ones_like(eid, dtype=torch.int64))


def dispatch_indices(idx: torch.Tensor, E: int, capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based slotting: for each (token, k) assignment return
    (expert_id, slot, keep) where slot < capacity or the token is dropped.

    Works on flattened (T*K,) expert ids; no (T,E,C) one-hot anywhere."""
    flat = idx.reshape(-1)                                # (T*K,)
    order = torch.argsort(flat, stable=True)
    ranked = flat[order]
    # position within its expert group = global rank - group offset
    counts = expert_counts(flat, E)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    pos_sorted = torch.arange(flat.shape[0], device=idx.device) \
        - offsets[ranked]
    pos = torch.zeros_like(flat)
    pos[order] = pos_sorted
    keep = pos < capacity
    return flat, torch.where(keep, pos, 0), keep


def capacity_of(T: int, moe: MoEConfig) -> int:
    """Slots per expert: the cf-scaled mean load with a floor of 8, capped
    at T (an expert receives each token at most once)."""
    return min(T, max(math.ceil(T * moe.top_k * moe.capacity_factor
                                / moe.n_experts), 8))


def dispatch(xt: torch.Tensor, K: int, eid: torch.Tensor,
             slot: torch.Tensor, keep: torch.Tensor, E: int,
             capacity: int) -> torch.Tensor:
    """The (E, C, D) dispatch buffer holding each kept (token, k) copy of
    ``xt`` (T, D) at (expert, slot), zeros elsewhere.  Every dropped copy
    lands on one scratch row past the buffer, which is cut off, so no
    kept row is ever written twice."""
    D = xt.shape[-1]
    src = torch.repeat_interleave(xt, K, dim=0)            # (T*K, D)
    rows = torch.where(keep, eid * capacity + slot, E * capacity)
    buf = torch.zeros((E * capacity + 1, D), dtype=xt.dtype,
                      device=xt.device)
    buf[rows] = src
    return buf[:E * capacity].view(E, capacity, D)


def _expert_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor | None) -> torch.Tensor:
    """(E,C,D) · (E,D,F) → (E,C,F): the kernel where ``group_sizes`` is
    given, else the reference's einsum (a batched product)."""
    if group_sizes is None:
        return torch.bmm(x, w)
    from ..kernels.moe_gmm import ops as gmm_ops
    E, C, D = x.shape
    Fo = w.shape[-1]
    # blocks that divide the shapes: they select the reference's checks
    # only, the kernel tiles by itself
    return gmm_ops.moe_gmm(x, w, group_sizes, c_block=math.gcd(C, 128),
                           f_block=math.gcd(Fo, 512),
                           d_block=math.gcd(D, 512))


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


#: ``mesh -> {axes: (process group, order)}`` (see :func:`axes_group`),
#: held no longer than the mesh is
_GROUPS = WeakIdKeyDictionary()


def axes_group(mesh, axes: tuple[str, ...]):
    """The process group over ``axes`` of ``mesh`` that holds this rank,
    and ``order``: ``order[g]`` is the position, in JAX's order over
    ``axes`` (the first named major), of the rank at position ``g`` of
    the group, which orders its ranks by mesh dim."""
    known = _GROUPS.setdefault(mesh, {})
    if tuple(axes) in known:
        return known[tuple(axes)]
    from torch.utils._python_dispatch import _disable_current_modes
    names = tuple(mesh.mesh_dim_names)
    in_mesh = sorted(axes, key=names.index)
    if len(in_mesh) == 1:
        group = mesh.get_group(in_mesh[0])
    else:
        sub = mesh if len(in_mesh) == len(names) else mesh[tuple(in_mesh)]
        # the mesh's own rank tables are real tensors, whatever mode the
        # caller runs under (the dry-run's fake tensors)
        with _disable_current_modes():
            group = sub._flatten().get_group()
    sizes = mesh_sizes(mesh)
    order = []
    for g in range(math.prod(sizes[a] for a in in_mesh)):
        coord, rest = {}, g
        for a in reversed(in_mesh):
            coord[a], rest = rest % sizes[a], rest // sizes[a]
        j = 0
        for a in axes:
            j = j * sizes[a] + coord[a]
        order.append(j)
    known[tuple(axes)] = (group, order)
    return group, order


class _GradAllReduce(torch.autograd.Function):
    """The identity forward; the gradient summed over ``group``: the
    cotangent of a ``local_map`` input that is replicated over the
    group's axes, as ``shard_map`` sums it there."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GradScale(torch.autograd.Function):
    """The identity forward; the gradient times ``k``: the cotangent of
    a ``local_map`` output that is replicated over ``1 / k`` ranks, as
    ``shard_map`` divides it."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.k, None


def _exchange(t: torch.Tensor, group, order: list) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` of ``t`` (G, ...) over an expert group:
    chunk ``i`` goes to the rank at position ``i`` in JAX's order, and
    chunk ``i`` of the result came from it.  The group orders its ranks
    by mesh dim, so the chunks are put in its order before the exchange
    and back in JAX's after it."""
    # torch.distributed.nn.functional's collectives carry gradients (the
    # functional ones have no all-reduce that does); newer torch marks
    # them deprecated, and that warning is left to show
    from torch.distributed.nn.functional import all_to_all_single
    G = t.shape[0]
    if order != list(range(G)):
        t = t[torch.tensor(order, device=t.device)]
    t = t.contiguous()
    out = all_to_all_single(torch.empty_like(t), t, group=group)
    if order != list(range(G)):
        inv = sorted(range(G), key=order.__getitem__)
        out = out[torch.tensor(inv, device=out.device)]
    return out


def _experts_over(payload: torch.Tensor, w_in: torch.Tensor,
                  w_out: torch.Tensor, G: int, group, order: list,
                  use_kernels: bool, tp_group=None) -> torch.Tensor:
    """The expert-parallel middle of a layer: a source's (E, cap, D)
    dispatch buffer goes out to the experts' owners (``G`` ranks of
    ``group``, ``E / G`` experts each, ``w_in``/``w_out`` this rank's),
    each rank runs its experts' SwiGLU over the ``G·cap`` rows every
    source sent it, and the results come home: (E·cap, D), row
    ``e·cap + slot`` the output of the row the source put there.  With
    ``use_kernels`` both products run the grouped-matmul kernel with
    every row live (rows from several sources are no one live prefix; a
    zero row gives a zero output).  ``tp_group`` sums the partial outputs
    of an expert's d_ff split over it before they go home."""
    from torch.distributed.nn.functional import all_reduce
    E, cap, D = payload.shape
    E_loc = E // G
    # (E, cap, D) -> (G, E_loc, cap, D): exchange source <-> group
    recv = _exchange(payload.view(G, E_loc, cap, D), group, order)
    toks = recv.transpose(0, 1).reshape(E_loc, G * cap, D)
    Fl = w_in.shape[-1]
    gs = (torch.full((E_loc,), G * cap, dtype=torch.int64,
                     device=payload.device) if use_kernels else None)
    h = _expert_matmul(toks, w_in.reshape(E_loc, D, 2 * Fl), gs) \
        .view(E_loc, G * cap, 2, Fl)
    act = F.silu(h[..., 0, :].to(F32)).to(payload.dtype) * h[..., 1, :]
    out = _expert_matmul(act, w_out, gs)
    if tp_group is not None:
        # d_ff is column-split over tp_axis: w_in produced a local
        # hidden slice, w_out contracted it -> partial sums
        out = all_reduce(out, group=tp_group)
    back = out.view(E_loc, G, cap, D).transpose(0, 1)
    return _exchange(back, group, order).reshape(E * cap, D)


def _combine(buf: torch.Tensor, eid: torch.Tensor, slot: torch.Tensor,
             keep: torch.Tensor, gate: torch.Tensor, K: int,
             cap: int) -> torch.Tensor:
    """(T, D): each token's kept copies from the (E·cap, D) results
    ``buf``, weighted by their gates and summed over k."""
    got = buf[eid * cap + slot]                            # (T*K, D)
    got = torch.where(keep[:, None], got, 0)
    got = got * gate.reshape(-1)[:, None].to(buf.dtype)
    return got.reshape(-1, K, buf.shape[-1]).sum(dim=1)


def _shared_experts(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The shared experts' SwiGLU of ``x`` (..., D), every token."""
    ws = p["w_shared_in"]
    hs = (x @ ws.reshape(ws.shape[0], -1)).unflatten(-1, ws.shape[1:])
    acts = F.silu(hs[..., 0, :].to(F32)).to(x.dtype) * hs[..., 1, :]
    return acts @ p["w_shared_out"]


def _replicated_over(mesh, used: tuple[str, ...]) -> tuple[str, ...]:
    """The mesh axes that a spec naming ``used`` leaves replicated."""
    return tuple(a for a in mesh.mesh_dim_names if a not in used)


def moe_ffn_ep(x: torch.Tensor, p: dict, cfg: ArchConfig,
               batch_axes: tuple[str, ...], expert_axes: tuple[str, ...],
               seq_axes: tuple[str, ...] = (), mesh=None,
               tp_axis: str | None = None, use_kernels: bool = False
               ) -> tuple[torch.Tensor, MoEAux]:
    """Expert-parallel MoE: the counterpart of the reference's
    ``shard_map`` + ``all_to_all`` path.

    Tokens are sharded over ``batch_axes`` × ``seq_axes``, experts over
    ``expert_axes`` (``G`` ranks, ``E / G`` experts each; several axes
    are read first-named major, as JAX reads them).  Each rank slots its
    own tokens per expert at a capacity of ``max(1, ceil(T_loc·K·cf /
    E))`` per source, ships them to the experts' owners with an
    ``all_to_all``, runs its experts' SwiGLU densely over the ``G·cap``
    rows each received, and ships the results home with a second one.
    ``tp_axis`` splits each expert's d_ff over that axis (Megatron
    style): the partial outputs are summed over it before going home.
    The aux losses and the dropped fraction are averaged over the batch,
    seq and expert axes.

    The body runs through ``local_map`` with the reference's specs as
    placements: DTensor inputs are localised as ``shard_map`` localises
    them, and a plain tensor is taken as this rank's block (``x`` its
    tokens, ``w_in``/``w_out`` its experts and d_ff slice, the router
    whole).  Gradients follow ``shard_map``'s transpose: an output's
    cotangent is divided by the ranks it is replicated over, an input's
    summed over the ranks it is replicated over, so each rank's gradient
    is its block of the global one.

    With ``use_kernels`` both expert products run the grouped-matmul
    kernel with every one of the ``G·cap`` rows live (rows from several
    sources are no one live prefix; a zero row gives a zero output)."""
    from torch.distributed.nn.functional import all_reduce
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    moe = cfg.moe
    mesh = mesh if mesh is not None else ambient_mesh()
    if tp_axis is not None:
        # expert-TP columns all need the SAME tokens (each computes a
        # d_ff slice): seq must be replicated over the tp axis
        seq_axes = tuple(a for a in seq_axes if a != tp_axis)
    B, S, D = x.shape
    E, K = moe.n_experts, moe.top_k
    sizes = mesh_sizes(mesh)
    G = math.prod(sizes[a] for a in expert_axes)
    ep_group, order = axes_group(mesh, tuple(expert_axes))
    tp_group = mesh.get_group(tp_axis) if tp_axis is not None else None
    paxes = tuple(dict.fromkeys(tuple(batch_axes) + tuple(seq_axes)
                                + tuple(expert_axes)))
    p_group, _ = axes_group(mesh, paxes)
    n_p = math.prod(sizes[a] for a in paxes)

    bspec = tuple(batch_axes) if batch_axes else None
    sspec = tuple(seq_axes) if seq_axes else None
    espec = tuple(expert_axes) if len(expert_axes) > 1 else expert_axes[0]
    x_spec = (bspec, sspec, None)
    if tp_axis is None:
        w_in_spec, w_out_spec = (espec,), (espec,)
    else:
        # (E, D, 2, Fe) column-split on Fe; (E, Fe, D) row-split on Fe
        w_in_spec = (espec, None, None, tp_axis)
        w_out_spec = (espec, tp_axis, None)
    specs = (x_spec, (None, None), w_in_spec, w_out_spec)
    used = [tuple(a for e in spec if e is not None
                  for a in ((e,) if isinstance(e, str) else e))
            for spec in specs]
    grad_groups = [axes_group(mesh, rep)[0] if rep else None
                   for rep in (_replicated_over(mesh, u) for u in used)]
    y_scale = 1.0 / math.prod(sizes[a] for a in _replicated_over(
        mesh, used[0]))
    aux_scale = 1.0 / math.prod(sizes.values())

    def body(x_loc, w_router, w_in, w_out):
        x_loc, w_router, w_in, w_out = (
            t if g is None else _GradAllReduce.apply(t, g)
            for t, g in zip((x_loc, w_router, w_in, w_out), grad_groups))
        Bl, Sl, _ = x_loc.shape
        T_loc = Bl * Sl
        xt = x_loc.reshape(T_loc, D)
        gate, idx, aux = router_topk(xt, w_router, moe)
        cap = max(1, math.ceil(T_loc * K * moe.capacity_factor / E))
        eid, slot, keep = dispatch_indices(idx, E, cap)
        payload = dispatch(xt, K, eid, slot, keep, E, cap)
        buf = _experts_over(payload, w_in, w_out, G, ep_group, order,
                            use_kernels, tp_group)
        y = _combine(buf, eid, slot, keep, gate, K, cap).reshape(Bl, Sl, D)
        dropped = 1.0 - torch.mean(keep.to(F32))
        means = all_reduce(torch.stack([aux.load_balance_loss,
                                        aux.router_z_loss, dropped]),
                           group=p_group) / n_p
        means = _GradScale.apply(means, aux_scale)
        return (_GradScale.apply(y, y_scale),
                MoEAux(means[0], means[1], means[2]))

    rep = (Replicate(),) * mesh.ndim
    fn = local_map(
        body,
        out_placements=(placements(mesh, x_spec), rep, rep, rep),
        in_placements=tuple(placements(mesh, s) for s in specs),
        device_mesh=mesh, redistribute_inputs=True)
    y, aux = fn(x, p["w_router"], p["w_in"], p["w_out"])

    if moe.n_shared:
        y = y + _shared_experts(x, p)
    return y, aux


@dataclass
class ExpertShare:
    """This rank's share of every MoE layer's routed experts when a model
    is served expert-parallel (``LM(experts=...)``): ``size`` ranks of
    ``group`` hold ``E / size`` consecutive experts each, this one those
    from ``rank · E / size``; ``order`` as :func:`axes_group` gives it.
    ``counters``, off (``None``) by default, is an int64 ``(size + 1,)``
    tensor on the device that each layer's exchange adds to: at ``g`` the
    kept (token, k) copies this rank sent to rank ``g``'s experts (summed
    over the ranks: the rows each rank's experts received), at ``size``
    the copies this rank dropped at the capacity.  In a CUDA graph the
    additions are captured, one per layer a step; :meth:`count` turns
    them on before the model's graphs are captured."""
    group: Any
    size: int
    rank: int
    order: list
    counters: torch.Tensor | None = None

    def local(self, E: int) -> int:
        """Experts a rank holds of a layer of ``E``."""
        if E % self.size:
            raise ValueError(f"{E} experts do not split over {self.size} "
                             "ranks")
        return E // self.size

    def count(self, device) -> torch.Tensor:
        """Turns the counters on (zeros) and returns them."""
        self.counters = torch.zeros(self.size + 1, dtype=torch.int64,
                                    device=device)
        return self.counters


def moe_ffn_serve_ep(x: torch.Tensor, p: dict, cfg: ArchConfig,
                     share: ExpertShare, use_kernels: bool = False
                     ) -> tuple[torch.Tensor, MoEAux]:
    """The MoE FFN of a model served expert-parallel, the decode step's
    (S = 1) included, which ``ep_applies`` keeps from ``moe_ffn_ep`` (the
    reference's rule).  ``x`` (B, S, D) is this rank's own rows and
    ``p`` holds the whole router and this rank's experts (``w_in``
    (E/G, D, 2, Fe), ``w_out`` (E/G, Fe, D)).  The rank routes its
    ``T = B·S`` tokens over all E experts, slots them per expert at
    ``capacity_of(T)`` per source (token-major; the rest dropped, so a
    rank's drops depend on its own rows alone), ships them to the
    experts' owners, runs its experts on the rows it received, ships the
    results home (``_experts_over``) and combines them with the gates;
    the shared experts run here, on its own rows.  Every rank of the
    group must call it with the same shapes, in step."""
    moe = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = moe.n_experts, moe.top_k
    cap = capacity_of(T, moe)
    xt = x.reshape(T, D)
    gate, idx, aux = router_topk(xt, p["w_router"], moe)
    eid, slot, keep = dispatch_indices(idx, E, cap)
    payload = dispatch(xt, K, eid, slot, keep, E, cap)
    buf = _experts_over(payload, p["w_in"], p["w_out"], share.size,
                        share.group, share.order, use_kernels)
    y = _combine(buf, eid, slot, keep, gate, K, cap)
    if share.counters is not None:
        sent = torch.zeros(E, dtype=torch.int64, device=x.device) \
            .index_add_(0, eid, keep.to(torch.int64))
        share.counters[:share.size].add_(sent.view(share.size, -1).sum(1))
        share.counters[share.size].add_((~keep).sum())
    if moe.n_shared:
        y = y + _shared_experts(xt, p)
    dropped = 1.0 - torch.mean(keep.to(F32))
    return y.reshape(B, S, D), aux._replace(dropped_fraction=dropped)


def ep_applies(ep, x_shape, moe: MoEConfig) -> bool:
    """Whether ``moe_ffn`` takes the expert-parallel path under the hint
    ``ep = (batch_axes, expert_axes, seq_axes, mesh, tp_axis)``: the
    reference's rule.  More than one expert group that divides the
    experts, more than one position (decode never takes it), d_ff
    divisible over the tp axis, and batch and seq divisible over their
    shards."""
    if ep is None:
        return False
    batch_axes, expert_axes, seq_axes, mesh, tp_axis = ep
    if mesh is None or not expert_axes:
        return False
    B, S = x_shape[:2]
    sizes = mesh_sizes(mesh)
    G = 1
    for a in expert_axes:
        G *= sizes.get(a, 0)
    sshard = 1
    for a in seq_axes:
        if a != tp_axis:
            sshard *= sizes.get(a, 1)
    bshard = 1
    for a in batch_axes:
        bshard *= sizes.get(a, 1)
    tp_ok = tp_axis is None or moe.d_expert % sizes.get(tp_axis, 1) == 0
    return (G > 1 and moe.n_experts % G == 0 and S > 1 and tp_ok
            and S % max(sshard, 1) == 0 and B % max(bshard, 1) == 0)


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig, constrain: Constrain,
            use_kernels: bool = False, ep=None
            ) -> tuple[torch.Tensor, MoEAux]:
    """x (B,S,D) → (B,S,D) with capacity-factor dropping.  With ``ep``
    given as (batch_axes, expert_axes, seq_axes, mesh, tp_axis) and a
    mesh whose expert axes span more than one rank, dispatch goes
    through the ``all_to_all`` path (``moe_ffn_ep``; ``ep_applies``)."""
    moe = cfg.moe
    if ep_applies(ep, x.shape, moe):
        batch_axes, expert_axes, seq_axes, mesh, tp_axis = ep
        return moe_ffn_ep(x, p, cfg, batch_axes, expert_axes, seq_axes,
                          mesh, tp_axis=tp_axis, use_kernels=use_kernels)
    B, S, D = x.shape
    T = B * S
    E, K, Fe = moe.n_experts, moe.top_k, moe.d_expert
    capacity = capacity_of(T, moe)

    xt = x.reshape(T, D)
    gate, idx, aux = router_topk(xt, p["w_router"], moe)
    eid, slot, keep = dispatch_indices(idx, E, capacity)

    disp = dispatch(xt, K, eid, slot, keep, E, capacity)
    disp = constrain(disp, ("experts", "cap", "d_model"), "moe_dispatched")

    gs = (torch.clamp(expert_counts(eid, E), max=capacity)
          if use_kernels else None)
    w_in = p["w_in"]
    h = _expert_matmul(disp, w_in.reshape(E, D, 2 * Fe), gs) \
        .view(E, capacity, 2, Fe)
    act = F.silu(h[..., 0, :].to(F32)).to(x.dtype) * h[..., 1, :]
    out_e = _expert_matmul(act, p["w_out"], gs)
    out_e = constrain(out_e, ("experts", "cap", "d_model"), "expert_out")

    # Gather back, weight by gate, sum over k.
    back = out_e[eid, slot]                                # (T*K, D)
    back = torch.where(keep[:, None], back, 0)
    back = back * gate.reshape(-1)[:, None].to(x.dtype)
    combined = back.reshape(T, K, D).sum(dim=1)

    if moe.n_shared:
        combined = combined + _shared_experts(xt, p)

    dropped = 1.0 - torch.mean(keep.to(F32))
    aux = aux._replace(dropped_fraction=dropped)
    return combined.reshape(B, S, D), aux
