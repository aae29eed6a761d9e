"""Mixture-of-Experts FFN on one card: top-k router with z-loss and
load-balance aux loss, sort-based capacity dispatch, expert SwiGLU
products, weighted combine, optional shared experts.

Counterpart of the single-card half of ``repro.models.moe`` (``moe_ffn``
without its ``ep`` branch; the ``all_to_all`` path ``moe_ffn_ep``, which
runs only under a plan and a mesh, is ROADMAP A9's rest), with the same
parameter paths, shapes and dtypes.

Two departures, both where the reference's result is unspecified:

* The dispatch buffer receives the kept (token, k) copies only.  The
  reference scatters every assignment and points the dropped ones at
  slot 0 with a zero row; a scatter with duplicate indices is unspecified
  in XLA (and in ``index_put`` on CUDA), and on the CPU the later zero
  wins, so slot 0 of an expert that overflows comes out zero although
  ``keep`` says its token was kept.  Here a dropped copy goes to one
  scratch row past the buffer, which is then cut off.
* With ``use_kernels`` both expert products run the grouped-matmul kernel
  (``kernels/moe_gmm``) with ``group_sizes = min(count_e, capacity)``.
  Rows past an expert's group size are zero in the buffer and so give
  zero outputs: the same function as the reference's einsums, which run
  without kernels.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoEConfig
from .layers import F32, ParamBuilder

Constrain = Callable[..., torch.Tensor]


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor
    router_z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


def init_moe(pb: ParamBuilder, path: str, cfg: ArchConfig,
             stack: int | None = None) -> None:
    moe = cfg.moe
    D, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
    pb.weight(f"{path}/w_router", (D, E), ("d_model", "experts"),
              dtype=F32, stack=stack)
    pb.weight(f"{path}/w_in", (E, D, 2, Fe),
              ("experts", "d_model", "two", "d_ff"), stack=stack)
    pb.weight(f"{path}/w_out", (E, Fe, D),
              ("experts", "d_ff", "d_model"), stack=stack)
    if moe.n_shared:
        Fs = moe.n_shared * Fe
        pb.weight(f"{path}/w_shared_in", (D, 2, Fs),
                  ("d_model", "two", "d_ff"), stack=stack)
        pb.weight(f"{path}/w_shared_out", (Fs, D), ("d_ff", "d_model"),
                  stack=stack)


def router_topk(x: torch.Tensor, w_router: torch.Tensor, moe: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor, MoEAux]:
    """(T,D) → gates (T,K), expert ids (T,K), aux losses."""
    logits = (x.to(F32) @ w_router).to(F32)               # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, moe.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss + z-loss.
    E = w_router.shape[-1]
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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ArchConfig, constrain: Constrain,
            use_kernels: bool = False) -> tuple[torch.Tensor, MoEAux]:
    """x (B,S,D) → (B,S,D) with capacity-factor dropping."""
    moe = cfg.moe
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
        ws = p["w_shared_in"]
        hs = (xt @ ws.reshape(D, -1)).unflatten(-1, ws.shape[1:])
        acts = F.silu(hs[..., 0, :].to(F32)).to(x.dtype) * hs[..., 1, :]
        combined = combined + acts @ p["w_shared_out"]

    dropped = 1.0 - torch.mean(keep.to(F32))
    aux = aux._replace(dropped_fraction=dropped)
    return combined.reshape(B, S, D), aux
