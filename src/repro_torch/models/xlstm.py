"""xLSTM blocks [arXiv:2405.04517].

Counterpart of ``repro.models.xlstm``, with the same parameter paths,
shapes and dtypes.

* **mLSTM** — matrix-memory LSTM, close to gated linear attention.  The
  full sequence runs the stabilised parallel form (quadratic in S) or,
  with ``use_kernels``, the chunkwise kernel (``kernels/mlstm_chunk``);
  decode runs the step form over an ``MLSTMState``.
* **sLSTM** — scalar-memory LSTM with exponential gating and a
  stabiliser state.  Its recurrence feeds h_{t-1} back through the gate
  pre-activations, so it runs step by step: the reference's
  ``lax.scan`` over time becomes a loop, which on CUDA a full sequence
  replays from a CUDA graph.

The mLSTM head dim is ``proj_factor_mlstm · d_model / n_heads`` (384 on
xlstm-125m), not ``cfg.resolved_head_dim``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import F32, ParamBuilder

Constrain = Callable[..., torch.Tensor]


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B,H,Dh,Dh) matrix memory
    n: torch.Tensor   # (B,H,Dh)    normaliser
    m: torch.Tensor   # (B,H)       stabiliser


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B,D)
    n: torch.Tensor   # (B,D)
    h: torch.Tensor   # (B,D)
    m: torch.Tensor   # (B,D)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->...")``: x's last dim against w's first,
    w's trailing dims kept."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def init_mlstm(pb: ParamBuilder, path: str, cfg: ArchConfig,
               stack: int | None = None) -> None:
    x = cfg.xlstm
    D = cfg.d_model
    Din = x.proj_factor_mlstm * D
    pb.weight(f"{path}/w_up", (D, 2 * Din), ("d_model", "d_inner"),
              stack=stack)
    pb.weight(f"{path}/w_qkv", (Din, 3, Din), ("d_inner", "three",
                                               "d_inner2"), stack=stack)
    pb.weight(f"{path}/w_if", (Din, 2, cfg.n_heads),
              ("d_inner", "two", "heads"), scale=0.01, stack=stack)
    pb.weight(f"{path}/w_down", (Din, D), ("d_inner", "d_model"),
              stack=stack)


def _mlstm_parallel(q, k, v, i_pre, f_pre):
    """Stabilised parallel form over the full sequence (quadratic).
    q,k,v (B,S,H,Dh); i_pre,f_pre (B,S,H) → (B,S,H,Dh) f32."""
    B, S, H, Dh = q.shape
    logf = F.logsigmoid(f_pre.to(F32))                     # (B,S,H)
    F_cum = torch.cumsum(logf, dim=1)
    # D[s,t] = sum_{r=t+1..s} logf_r + i_t  for t<=s
    dmat = (F_cum[:, :, None] - F_cum[:, None, :]
            + i_pre.to(F32)[:, None, :, :])                # (B,S,T,H)
    tpos = torch.arange(S, device=q.device)
    causal = tpos[None, :, None] >= tpos[None, None, :]
    dmat = torch.where(causal[..., None], dmat, -torch.inf)
    m = torch.amax(dmat, dim=2, keepdim=True)              # (B,S,1,H)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bshd,bthd->bsth", q.to(F32),
                          k.to(F32)) / (Dh ** 0.5)
    w = scores * dexp
    norm = torch.maximum(torch.abs(torch.sum(w, dim=2)),
                         torch.exp(-m[:, :, 0]))
    y = torch.einsum("bsth,bthd->bshd", w, v.to(F32))
    return y / (norm[..., None] + 1e-6)


def _mlstm_step(q, k, v, i_pre, f_pre, state: MLSTMState):
    """Step form: exponential-gated rank-1 update of the matrix memory.
    q,k,v (B,1,H,Dh); i_pre,f_pre (B,1,H) → y (B,H,Dh) f32, new state."""
    Dh = q.shape[-1]
    logf = F.logsigmoid(f_pre.to(F32))[:, 0]                # (B,H)
    i_t = i_pre.to(F32)[:, 0]
    m_new = torch.maximum(logf + state.m, i_t)
    fg = torch.exp(logf + state.m - m_new)[..., None]
    ig = torch.exp(i_t - m_new)[..., None]
    kt = k.to(F32)[:, 0] / (Dh ** 0.5)
    vt = v.to(F32)[:, 0]
    C = fg[..., None] * state.C + ig[..., None] * (
        kt[..., :, None] * vt[..., None, :])
    n = fg * state.n + ig * kt
    qt = q.to(F32)[:, 0]
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt, n)),
                        torch.exp(-m_new))[..., None]
    return num / (den + 1e-6), MLSTMState(C, n, m_new)


def mlstm_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                constrain: Constrain,
                state: Optional[MLSTMState] = None,
                use_kernels: bool = False):
    """x (B,S,D) → (B,S,D); with ``state`` (decode, S = 1) also the new
    state.  ``use_kernels`` runs the chunkwise kernel on the full
    sequence."""
    xc = cfg.xlstm
    D = cfg.d_model
    Din = xc.proj_factor_mlstm * D
    H = cfg.n_heads
    Dh = Din // H
    B, S, _ = x.shape

    up = x @ p["w_up"]
    up = constrain(up, ("batch", "seq", "d_inner"), "up")
    xin, z = up[..., :Din], up[..., Din:]
    qkv = _proj(xin, p["w_qkv"])                            # (B,S,3,Din)
    q, k, v = (qkv[:, :, i].reshape(B, S, H, Dh) for i in range(3))
    if_pre = _proj(xin, p["w_if"])                          # (B,S,2,H)
    i_pre, f_pre = if_pre[:, :, 0], if_pre[:, :, 1]

    new_state = None
    if state is not None:
        y, new_state = _mlstm_step(q, k, v, i_pre, f_pre, state)
        y = y[:, None].reshape(B, 1, Din)
    elif use_kernels:
        from ..kernels.mlstm_chunk import ops as mlstm_ops
        y = mlstm_ops.mlstm_chunk(q, k, v, i_pre, f_pre,
                                  chunk=xc.chunk).reshape(B, S, Din)
    else:
        y = _mlstm_parallel(q, k, v, i_pre, f_pre).reshape(B, S, Din)

    y = (y * F.silu(z.to(F32))).to(x.dtype)
    y = constrain(y, ("batch", "seq", "d_inner"), "scan_out")
    out = y @ p["w_down"]
    if state is not None:
        return out, new_state
    return out


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def init_slstm(pb: ParamBuilder, path: str, cfg: ArchConfig,
               stack: int | None = None) -> None:
    x = cfg.xlstm
    D = cfg.d_model
    pb.weight(f"{path}/w_gates", (D, 4, D), ("d_model", "four", "d_inner"),
              stack=stack)
    pb.weight(f"{path}/r_gates", (D, 4, D), ("d_model", "four", "d_inner"),
              scale=0.01, stack=stack)
    if x.d_ff_slstm:
        pb.weight(f"{path}/w_ffn_in", (D, 2, x.d_ff_slstm),
                  ("d_model", "two", "d_ff"), stack=stack)
        pb.weight(f"{path}/w_ffn_out", (x.d_ff_slstm, D),
                  ("d_ff", "d_model"), stack=stack)


def _gate_weights(p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``w_gates`` and ``r_gates`` cast to f32, once per sequence: the
    reference casts them at every step, which computes the same values,
    but autograd would keep each step's f32 copies (2 x 9.44 MB a step at
    xlstm-125m's width) and sum each step's gradient in bf16."""
    return p["w_gates"].to(F32), p["r_gates"].to(F32)


def _slstm_step(w: torch.Tensor, r: torch.Tensor, state: SLSTMState,
                x_t: torch.Tensor) -> tuple[SLSTMState, torch.Tensor]:
    """One exponential-gated sLSTM step; x_t (B,D), the gate weights
    ``w``, ``r`` (D,4,D) in f32 (``_gate_weights``).  The gate products
    run in f32, as in the reference."""
    pre = _proj(x_t.to(F32), w) + _proj(state.h, r)       # (B,4,D)
    i_p, f_p, z_p, o_p = (pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3])
    logf = F.logsigmoid(f_p)
    m_new = torch.maximum(logf + state.m, i_p)
    ig = torch.exp(i_p - m_new)
    fg = torch.exp(logf + state.m - m_new)
    z = torch.tanh(z_p)
    c = fg * state.c + ig * z
    n = fg * state.n + ig
    h = torch.sigmoid(o_p) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c, n, h, m_new), h


def _fresh_slstm(B: int, D: int, device) -> SLSTMState:
    """A fresh sequence's state: zeros and ``m = -1e30`` (the reference's
    ``slstm_block``; the caches of ``LM.init_caches`` start from 0)."""
    zeros = [torch.zeros((B, D), dtype=F32, device=device) for _ in range(3)]
    return SLSTMState(*zeros, torch.full((B, D), -1e30, dtype=F32,
                                         device=device))


def _slstm_scan(p: dict, x: torch.Tensor, carry: SLSTMState
                ) -> tuple[torch.Tensor, SLSTMState]:
    """The recurrence over x (B,S,D) step by step: the reference's
    ``lax.scan`` over time as a loop, the gate weights cast once.
    Returns (y in x's dtype, carry)."""
    w, r = _gate_weights(p)
    hs = []
    for t in range(x.shape[1]):
        carry, h = _slstm_step(w, r, carry, x[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), carry


class _ScanGraph:
    """The recurrence from a fresh state over a static copy of x,
    captured once in a CUDA graph (``launch/graphs.Graph``) and replayed:
    the counterpart of the reference's jitted ``lax.scan``, whose S steps
    of ~15 small operations each the host would otherwise issue one by
    one.  The graph reads the weights at the addresses it was captured
    with, so it is memoised on those addresses (``_scan_graph``)."""

    def __init__(self, p: dict, x: torch.Tensor):
        from ..launch.graphs import Graph
        B, _, D = x.shape
        self.x = x.clone()
        self.y = None

        def body():
            self.y = _slstm_scan(p, self.x, _fresh_slstm(B, D, x.device))[0]

        def warmup():
            _slstm_step(*_gate_weights(p), _fresh_slstm(B, D, x.device),
                        self.x[:, 0])
        self.graph = Graph(body, warmup, x.device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        self.graph.replay()
        return self.y.clone()


def _scan_graph(p: dict, x: torch.Tensor) -> torch.Tensor:
    """y of the fresh-state recurrence over x, replayed from the graph
    memoised on x's shape and the weights' addresses and layouts."""
    from ..launch.graphs import memo
    ws = [p["w_gates"], p["r_gates"]]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x, *ws]):
        raise RuntimeError("the sLSTM's CUDA graph carries no gradients: "
                           "build the LM with graphs=False to train it")
    key = ("slstm", tuple(x.shape), x.dtype, x.device,
           *((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
             for t in ws))
    return memo(key, lambda: _ScanGraph(p, x))(x)


def slstm_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                constrain: Constrain,
                state: Optional[SLSTMState] = None,
                graphs: bool | None = None):
    """x (B,S,D) → (B,S,D); with ``state`` also the final state.  A fresh
    sequence (no ``state``) on CUDA replays its recurrence from a CUDA
    graph unless ``graphs`` is False; on the CPU it always loops."""
    B, S, D = x.shape
    if state is None and x.is_cuda and graphs is not False:
        y, carry = _scan_graph(p, x), None
    else:
        y, carry = _slstm_scan(p, x, state if state is not None
                               else _fresh_slstm(B, D, x.device))
    y = constrain(y, ("batch", "seq", "d_model"), "scan_out")

    if "w_ffn_in" in p:
        h = _proj(y, p["w_ffn_in"])                         # (B,S,2,F)
        act = F.silu(h[..., 0, :].to(F32)).to(x.dtype) * h[..., 1, :]
        y = act @ p["w_ffn_out"]
    if state is not None:
        return y, carry
    return y
