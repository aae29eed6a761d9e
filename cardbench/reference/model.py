"""Plain PyTorch reference of the decoder families the benchmark runs.

Written from the layer equations, not from the program: a dense
pre-norm decoder (RMSNorm, GQA attention with interleaved-pair RoPE, a
SwiGLU MLP) and the hybrid of Mamba mixers, GQA attention and a top-k
mixture of experts with per-expert capacity.  It computes in float32
with TF32 off (``Precision.F32``), or, as the control of the benchmark's
comparisons, with the operands of every linear layer rounded to fp8
(``Precision.FP8``: e4m3, one scale per tensor).

Parameters are a flat ``{path: tensor}`` dict in the layout the
benchmark hands to both sides (``param_specs``): a group of layers that
repeats a pattern stacks its leaves on a leading axis, and a leaf of
layer ``i`` is ``group{g}/b{j}/...`` at index ``r`` of that axis.  The
reference reads them in any dtype and computes in float32.

Mixture-of-experts capacity is part of the semantics: tokens are routed
in *routing groups* (all tokens of one call of the layer), each expert
keeps at most ``capacity(T)`` of a group's (token, k) assignments, in
token-major order, and drops the rest.  ``forward`` takes the groups as
``"sequence"`` (one group of all B·S tokens, a full-sequence call) or
``"position"`` (one group per position of B tokens, a decode step over
B rows).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

F32 = torch.float32
_NEG = -1e30
FP8_MAX = 448.0


class Precision:
    F32 = "f32"
    FP8 = "fp8"


def q_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude maps to 448), returned in float32; the gradient
    passes the rounding unchanged."""
    t = t.to(F32)
    with torch.no_grad():
        s = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (t / s).to(torch.float8_e4m3fn).to(F32) * s
    return t + (q - t).detach()


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

def block_kind(arch: dict, i: int) -> str:
    if arch.get("mamba") and arch.get("attn_every"):
        return "attn" if i % arch["attn_every"] == arch["attn_offset"] \
            else "mamba"
    return "attn"


def ffn_kind(arch: dict, i: int) -> str:
    if not arch.get("moe"):
        return "dense"
    if i < arch.get("n_dense_layers", 0):
        return "dense"
    every = arch.get("moe_every", 1)
    if every > 1 and i % every != 1:
        return "dense"
    return "moe"


def layer_kinds(arch: dict) -> list[tuple[str, str]]:
    return [(block_kind(arch, i), ffn_kind(arch, i))
            for i in range(arch["n_layers"])]


def layer_groups(arch: dict) -> list[tuple[tuple, int]]:
    """The layers as (pattern, repeats): the shortest period ``p`` and
    the shortest prefix after which the kinds repeat with period ``p``;
    the prefix layers one group each, the periodic body one stacked
    group."""
    kinds = layer_kinds(arch)
    n = len(kinds)
    for period in range(1, n + 1):
        for start in range(0, min(period, n - 1) + 1):
            body = kinds[start:]
            if len(body) % period:
                continue
            pat = tuple(body[:period])
            if all(tuple(body[j * period:(j + 1) * period]) == pat
                   for j in range(len(body) // period)):
                return [((k,), 1) for k in kinds[:start]] + \
                    [(pat, len(body) // period)]
    return [(tuple(kinds), 1)]


def layer_sites(arch: dict) -> list[tuple[str, int | None, str, str]]:
    """Per layer in order: (path prefix, index on the stacked axis or
    None, mixer kind, FFN kind)."""
    out = []
    for g, (pat, reps) in enumerate(layer_groups(arch)):
        for r in range(reps):
            for j, (mix, ffn) in enumerate(pat):
                out.append((f"group{g}/b{j}", r if reps > 1 else None,
                            mix, ffn))
    return out


def head_dim(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def dt_rank(arch: dict) -> int:
    return max(8, arch["d_model"] // 16)


def param_specs(arch: dict) -> dict[str, tuple[tuple, str, str, float]]:
    """``{path: (shape, dtype, init, std)}``: ``init`` is ``normal``
    (std given), ``ones`` or ``zeros``; dtype ``bf16`` or ``f32``.  A
    normal leaf has std ``1/sqrt(fan_in)``, ``fan_in`` the dims its
    product contracts, so activations keep unit scale through every
    layer; the embedding and the head 0.02, the conv taps 0.5."""
    D, H, KV, Dh = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                    head_dim(arch))
    specs: dict = {}

    def w(path, shape, stack, fan_in=None, std=None, dtype="bf16"):
        std = std if std is not None else 1.0 / math.sqrt(
            fan_in or shape[0])
        full = ((stack,) if stack else ()) + tuple(shape)
        specs[path] = (full, dtype, "normal", std)

    def c(path, shape, stack, init):
        full = ((stack,) if stack else ()) + tuple(shape)
        specs[path] = (full, "f32", init, 0.0)

    w("embed", (arch["vocab"], D), None, std=0.02)
    for g, (pat, reps) in enumerate(layer_groups(arch)):
        st = reps if reps > 1 else None
        for j, (mix, ffn) in enumerate(pat):
            p = f"group{g}/b{j}"
            c(f"{p}/norm1/scale", (D,), st, "ones")
            if mix == "attn":
                w(f"{p}/mix/w_q", (D, H, Dh), st)
                w(f"{p}/mix/w_kv", (D, 2, KV, Dh), st)
                w(f"{p}/mix/w_o", (H, Dh, D), st, fan_in=H * Dh)
            else:
                mb = arch["mamba"]
                Din, N, R = mb["expand"] * D, mb["d_state"], dt_rank(arch)
                w(f"{p}/mix/w_in", (D, 2 * Din), st)
                w(f"{p}/mix/w_conv", (mb["d_conv"], Din), st, std=0.5)
                w(f"{p}/mix/w_x", (Din, R + 2 * N), st)
                w(f"{p}/mix/w_dt", (R, Din), st)
                c(f"{p}/mix/a_log", (Din, N), st, "zeros")
                c(f"{p}/mix/d_skip", (Din,), st, "ones")
                w(f"{p}/mix/w_out", (Din, D), st)
            c(f"{p}/norm2/scale", (D,), st, "ones")
            if ffn == "dense":
                Fd = arch.get("dense_d_ff") or arch["d_ff"]
                w(f"{p}/ffn/w_in", (D, 2, Fd), st)
                w(f"{p}/ffn/w_out", (Fd, D), st)
            else:
                m = arch["moe"]
                E, Fe = m["n_experts"], m["d_expert"]
                w(f"{p}/ffn/w_router", (D, E), st, dtype="f32")
                w(f"{p}/ffn/w_in", (E, D, 2, Fe), st, fan_in=D)
                w(f"{p}/ffn/w_out", (E, Fe, D), st, fan_in=Fe)
    c("final_norm/scale", (D,), None, "ones")
    if not arch.get("tie_embeddings"):
        w("head", (D, arch["vocab"]), None, std=0.02)
    return specs


def leaf(params: dict, path: str, idx: int | None) -> torch.Tensor:
    t = params[path]
    return t if idx is None else t[idx]


# --------------------------------------------------------------------------
# the forward pass
# --------------------------------------------------------------------------

@dataclass
class Ref:
    """The reference over ``params`` (flat dict).  ``capacity`` is the
    expert capacity rule: ``T -> slots per expert`` for a routing group
    of ``T`` tokens."""
    arch: dict
    params: dict
    precision: str = Precision.F32
    norm_eps: float = 1e-6
    rope_base: float = 10000.0
    q_block: int = 512

    def __post_init__(self):
        self.sites = layer_sites(self.arch)

    # -- pieces ---------------------------------------------------------
    def w(self, path, idx=None) -> torch.Tensor:
        return leaf(self.params, path, idx).to(F32)

    def lin(self, x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
        """``x @ wt`` (wt (K, N)), both in float32, or rounded to fp8."""
        if self.precision == Precision.FP8:
            x, wt = q_fp8(x), q_fp8(wt)
        return x @ wt

    def norm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.norm_eps) * scale

    def rope(self, x, pos):
        """x (B, S, H, Dh); rotate the first ``rot`` features in
        interleaved pairs (0::2 with 1::2)."""
        Dh = x.shape[-1]
        rot = int(Dh * self.arch.get("rope_pct", 1.0)) & ~1
        if rot == 0:
            return x
        inv = torch.tensor(
            [1.0 / self.rope_base ** (i / rot) for i in range(0, rot, 2)],
            dtype=torch.float64).to(F32).to(x.device)
        ang = pos.to(F32)[:, :, None] * inv           # (B, S, rot/2)
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        a, b = x[..., 0:rot:2], x[..., 1:rot:2]
        out = torch.stack([a * cos - b * sin, b * cos + a * sin], -1)
        return torch.cat([out.flatten(-2), x[..., rot:]], -1)

    def attention(self, x, pfx, idx, pos):
        B, S, D = x.shape
        H, KV, Dh = self.arch["n_heads"], self.arch["n_kv_heads"], \
            head_dim(self.arch)
        q = self.lin(x, self.w(f"{pfx}/mix/w_q", idx).reshape(D, H * Dh))
        kv = self.lin(x, self.w(f"{pfx}/mix/w_kv", idx).reshape(D, -1))
        q = self.rope(q.view(B, S, H, Dh), pos)
        kv = kv.view(B, S, 2, KV, Dh)
        k, v = self.rope(kv[:, :, 0], pos), kv[:, :, 1]
        G = H // KV
        window = self.arch.get("attn_window")
        ctx = torch.empty(B, S, H, Dh, dtype=F32, device=x.device)
        kt = k.permute(0, 2, 3, 1)                    # (B, KV, Dh, S)
        vt = v.permute(0, 2, 1, 3)                    # (B, KV, S, Dh)
        kpos = torch.arange(S, device=x.device)
        for s0 in range(0, S, self.q_block):
            s1 = min(S, s0 + self.q_block)
            qb = q[:, s0:s1].reshape(B, s1 - s0, KV, G, Dh) \
                .permute(0, 2, 3, 1, 4)               # (B, KV, G, s, Dh)
            sc = (qb @ kt[:, :, None]) / math.sqrt(Dh)  # (B,KV,G,s,S)
            qpos = kpos[s0:s1, None]
            ok = kpos[None, :] <= qpos
            if window:
                ok = ok & (kpos[None, :] > qpos - window)
            sc = torch.where(ok, sc, _NEG).softmax(-1)
            o = sc @ vt[:, :, None]                   # (B,KV,G,s,Dh)
            ctx[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(
                B, s1 - s0, H, Dh)
            del sc, o
        wo = self.w(f"{pfx}/mix/w_o", idx).reshape(H * Dh, D)
        return self.lin(ctx.reshape(B, S, H * Dh), wo)

    def scan(self, x, dt, A, Bm, Cm):
        """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, y_t = h_t · C_t, in
        chunks of steps: within a chunk the prefix products and sums by
        doubling, the state carried between chunks.  A chunk holds about
        2^24 states."""
        Bsz, S, Din = x.shape
        N = A.shape[-1]
        chunk = max(8, min(128, (1 << 24) // (Bsz * Din * N)))
        h = torch.zeros(Bsz, Din, N, dtype=F32, device=x.device)
        y = torch.empty(Bsz, S, Din, dtype=F32, device=x.device)
        for c0 in range(0, S, chunk):
            c1 = min(S, c0 + chunk)
            a = torch.exp(dt[:, c0:c1, :, None] * A)          # (B,c,Din,N)
            u = (dt[:, c0:c1] * x[:, c0:c1])[..., None] * \
                Bm[:, c0:c1, None, :]
            k = 1
            while k < c1 - c0:
                u = torch.cat([u[:, :k], u[:, k:] + a[:, k:] * u[:, :-k]], 1)
                a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
                k *= 2
            hs = u + a * h[:, None]
            y[:, c0:c1] = (hs * Cm[:, c0:c1, None, :]).sum(-1)
            h = hs[:, -1]
            del a, u, hs
        return y

    def mamba(self, x, pfx, idx):
        mb = self.arch["mamba"]
        B, S, D = x.shape
        Din, N, R, K = mb["expand"] * D, mb["d_state"], dt_rank(self.arch), \
            mb["d_conv"]
        xz = self.lin(x, self.w(f"{pfx}/mix/w_in", idx))
        xin, z = xz[..., :Din], xz[..., Din:]
        wc = self.w(f"{pfx}/mix/w_conv", idx)                 # (K, Din)
        xp = F.pad(xin, (0, 0, K - 1, 0))
        xc = sum(xp[:, i:i + S] * wc[i] for i in range(K))
        xc = F.silu(xc)
        proj = self.lin(xc, self.w(f"{pfx}/mix/w_x", idx))
        dt = F.softplus(self.lin(proj[..., :R], self.w(f"{pfx}/mix/w_dt",
                                                       idx)))
        Bm, Cm = proj[..., R:R + N], proj[..., R + N:]
        A = -torch.exp(self.w(f"{pfx}/mix/a_log", idx)) - torch.arange(
            1, N + 1, dtype=F32, device=x.device)
        y = self.scan(xc, dt, A, Bm, Cm)
        y = (y + xc * self.w(f"{pfx}/mix/d_skip", idx)) * F.silu(z)
        return self.lin(y, self.w(f"{pfx}/mix/w_out", idx))

    def swiglu(self, x, w_in, w_out):
        """w_in (D, 2, F), w_out (F, D)."""
        h = self.lin(x, w_in.reshape(w_in.shape[0], -1)) \
            .view(*x.shape[:-1], 2, w_in.shape[-1])
        return self.lin(F.silu(h[..., 0, :]) * h[..., 1, :], w_out)

    def capacity(self, T: int) -> int:
        m = self.arch["moe"]
        return min(T, max(math.ceil(T * m["top_k"] * m["capacity_factor"]
                                    / m["n_experts"]), 8))

    def moe(self, x, pfx, idx, groups: str):
        """x (B, S, D); routing groups per ``groups`` (module doc)."""
        m = self.arch["moe"]
        B, S, D = x.shape
        E, K = m["n_experts"], m["top_k"]
        xt = (x if groups == "sequence" else x.transpose(0, 1)) \
            .reshape(-1, D)                     # token-major per group
        Tg = B * S if groups == "sequence" else B
        logits = xt @ self.w(f"{pfx}/ffn/w_router", idx)
        gate, eid = torch.topk(logits.softmax(-1), K, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        cap = self.capacity(Tg)
        # rank of each (token, k) among its group's assignments to its
        # expert, in token-major order
        n = xt.shape[0]
        grp = (torch.arange(n, device=x.device) // Tg)[:, None] \
            .expand(n, K).reshape(-1)
        key = grp * E + eid.reshape(-1)
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=(n // Tg) * E)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(key)
        rank[order] = torch.arange(key.numel(), device=x.device) \
            - starts[key[order]]
        keep = (rank < cap).view(n, K)
        w_in = leaf(self.params, f"{pfx}/ffn/w_in", idx)
        w_out = leaf(self.params, f"{pfx}/ffn/w_out", idx)
        y = torch.zeros_like(xt)
        for e in range(E):
            tok, kk = torch.nonzero((eid == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            out = self.swiglu(xt[tok], w_in[e].to(F32), w_out[e].to(F32))
            y.index_add_(0, tok, out * gate[tok, kk, None])
        y = y.view(S, B, D).transpose(0, 1) if groups != "sequence" \
            else y.view(B, S, D)
        return y

    # -- the model ------------------------------------------------------
    def embed(self, tokens):
        return self.w("embed")[tokens]

    def layer(self, resid, site, pos, groups):
        pfx, idx, mix, ffn = site
        x = self.norm(resid, self.w(f"{pfx}/norm1/scale", idx))
        resid = resid + (self.attention(x, pfx, idx, pos) if mix == "attn"
                         else self.mamba(x, pfx, idx))
        x = self.norm(resid, self.w(f"{pfx}/norm2/scale", idx))
        if ffn == "dense":
            return resid + self.swiglu(x, self.w(f"{pfx}/ffn/w_in", idx),
                                       self.w(f"{pfx}/ffn/w_out", idx))
        return resid + self.moe(x, pfx, idx, groups)

    def head(self, resid):
        x = self.norm(resid, self.w("final_norm/scale"))
        table = self.w("embed").T if self.arch.get("tie_embeddings") \
            else self.w("head")
        return self.lin(x, table)

    def forward(self, tokens: torch.Tensor, groups: str = "sequence",
                at: torch.Tensor | None = None,
                layer_fn: Callable | None = None) -> torch.Tensor:
        """Logits (B, S, vocab) of ``tokens`` (B, S), or only at the
        positions ``at`` (a (B, S) bool mask: rows (n, vocab)).
        ``layer_fn(layer, resid, site)`` may wrap each layer (the train
        reference recomputes them in the backward pass)."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        resid = self.embed(tokens)
        for site in self.sites:
            if layer_fn is None:
                resid = self.layer(resid, site, pos, groups)
            else:
                resid = layer_fn(self.layer, resid, site, pos, groups)
        if at is not None:
            resid = resid[at]
        return self.head(resid)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy plus ``z_loss`` times the mean squared
    log-partition, in float32."""
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None]).squeeze(-1)
    return (lse - gold).mean() + z_loss * (lse * lse).mean()
