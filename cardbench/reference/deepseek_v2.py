"""Plain PyTorch reference of DeepSeek-V2 (arXiv:2405.04434, and the
published ``config.json``), and the rule its weights are drawn by.

Written from the layer equations, not from the program.  A layer ``l``
of the residual stream ``h`` (B, S, d):

    x   = RMSNorm(h)
    c_q = RMSNorm(x W_qa)                         (q_lora; q_a_layernorm)
    q   = c_q W_qb, split per head into q_nope (128) and q_pe (64)
    c   = x W_kva, split into c_kv (512) and k_pe (64, shared by heads)
    c_kv = RMSNorm(c_kv)                          (kv_a_layernorm)
    k_nope[h] = c_kv W_uk[h],  v[h] = c_kv W_uv[h]
    q_pe, k_pe rotated by YaRN's RoPE at each position
    a[h] = softmax_causal((q_nope[h]·k_nope[h] + q_pe[h]·k_pe) · s)
    h  += (Σ_h a[h] v[h]) W_o,   s = m² / sqrt(192),  m = 0.1·0.707·ln 40 + 1
    x   = RMSNorm(h)
    h  += FFN(x)

FFN is the dense SwiGLU in the first ``n_dense_layers`` layers and the
MoE after: two shared SwiGLU experts on every token, plus the routed
ones.  Routing (``group_limited_greedy``): p = softmax(x W_r) over the
E experts; the experts fall in ``n_group`` groups of consecutive ids,
each scored by its largest p; a token keeps its ``topk_group`` best
groups and picks its top-k experts in them; each picked expert's output
is weighted by its p times ``routed_scale`` (no renormalisation).

Departures from the published model, which the program shares:

* Expert capacity: each routing group (``groups``: ``"position"``, the
  B rows of one decode step, one source's tokens in expert-parallel
  serving; ``"sequence"``, all tokens of a call) keeps at most
  ``min(T, max(ceil(T·k·cf/E), 8))`` of its (token, k) copies per
  expert, in token-major order, and drops the rest (published inference
  is dropless).
* RoPE rotates interleaved pairs (0::2 with 1::2); the published code
  rotates halves, the same function up to a fixed permutation of the
  rope columns of ``W_qb`` and ``W_kva``.

It computes in float32 with TF32 off (``Precision.F32``), or, as the
control, with the operands of every linear layer (the latent
up-projections included) rounded to fp8 e4m3 (``Precision.FP8``), or,
as a witness of what the program's own precision gives, rounded to
bfloat16 (``BF16``).

Weights: every leaf is drawn from the run's seed by ``draw``, one
generator a (leaf, layer) and, for the routed experts' matrices, one a
(leaf, layer, expert), so a rank that holds some experts draws exactly
those, and the reference draws one layer's experts at a time: one
layer's 160 experts in bfloat16 (7.55 GB at DeepSeek-V2's widths) is
the largest thing it holds beside the residual stream.
"""
from __future__ import annotations

import math
import zlib

import torch
import torch.nn.functional as F

from cardbench.harness import seed_mix
from cardbench.reference.model import (F32, Precision, layer_groups,
                                        layer_sites, q_fp8)

_NEG = -1e30
_DT = {"bf16": torch.bfloat16, "f32": torch.float32}
#: the precision of the witness (module doc)
BF16 = "bf16"


# --------------------------------------------------------------------------
# layout and the drawing rule
# --------------------------------------------------------------------------

EXPERT_LEAVES = ("w_in", "w_out")


def param_specs(arch: dict, held: int | None = None) -> dict:
    """``{path: (shape, dtype, init, std)}`` in the program's layout: a
    stacked group's leaves lead with its layers axis; the routed experts'
    matrices hold ``held`` experts (all by default).  A normal leaf has
    std ``1/sqrt(fan_in)`` (the dims its product contracts); the
    embedding and the head 0.02."""
    D, H = arch["d_model"], arch["n_heads"]
    m, moe = arch["mla"], arch["moe"]
    E, Fe = moe["n_experts"], moe["d_expert"]
    El = E if held is None else held
    Dqk = m["nope_dim"] + m["rope_dim"]
    specs: dict = {}

    def w(path, shape, stack, fan_in, std=None, dtype="bf16"):
        full = ((stack,) if stack else ()) + tuple(shape)
        specs[path] = (full, dtype, "normal",
                       std if std is not None else 1.0 / math.sqrt(fan_in))

    def ones(path, shape, stack):
        specs[path] = (((stack,) if stack else ()) + tuple(shape), "f32",
                       "ones", 0.0)

    specs["embed"] = ((arch["vocab"], D), "bf16", "normal", 0.02)
    for g, (pat, reps) in enumerate(layer_groups(arch)):
        st = reps if reps > 1 else None
        for j, (_mix_kind, ffn) in enumerate(pat):
            p = f"group{g}/b{j}"
            ones(f"{p}/norm1/scale", (D,), st)
            w(f"{p}/mix/w_q_a", (D, m["q_lora"]), st, D)
            w(f"{p}/mix/w_q_b", (m["q_lora"], H, Dqk), st, m["q_lora"])
            w(f"{p}/mix/w_kv_a", (D, m["kv_lora"] + m["rope_dim"]), st, D)
            w(f"{p}/mix/w_uk", (H, m["kv_lora"], m["nope_dim"]), st,
              m["kv_lora"])
            w(f"{p}/mix/w_uv", (H, m["kv_lora"], m["v_dim"]), st,
              m["kv_lora"])
            w(f"{p}/mix/w_o", (H, m["v_dim"], D), st, H * m["v_dim"])
            if m.get("latent_norm"):
                ones(f"{p}/mix/q_norm/scale", (m["q_lora"],), st)
                ones(f"{p}/mix/kv_norm/scale", (m["kv_lora"],), st)
            ones(f"{p}/norm2/scale", (D,), st)
            if ffn == "dense":
                Fd = arch["dense_d_ff"]
                w(f"{p}/ffn/w_in", (D, 2, Fd), st, D)
                w(f"{p}/ffn/w_out", (Fd, D), st, Fd)
            else:
                Fs = moe["n_shared"] * Fe
                w(f"{p}/ffn/w_router", (D, E), st, D, dtype="f32")
                w(f"{p}/ffn/w_in", (El, D, 2, Fe), st, D)
                w(f"{p}/ffn/w_out", (El, Fe, D), st, Fe)
                if Fs:
                    w(f"{p}/ffn/w_shared_in", (D, 2, Fs), st, D)
                    w(f"{p}/ffn/w_shared_out", (Fs, D), st, Fs)
    ones("final_norm/scale", (D,), None)
    specs["head"] = ((D, arch["vocab"]), "bf16", "normal", 0.02)
    return specs


def draw(spec: tuple, seed: int, path: str, layer: int | None = None,
         expert: int | None = None, device="cpu") -> torch.Tensor:
    """One unit of leaf ``path`` (``spec`` its whole shape): the slice of
    layer ``layer`` (a stacked leaf; else ``None``) and expert ``expert``
    (a routed expert's matrix; else ``None``), drawn from a generator
    seeded with (seed, path, layer, expert)."""
    shape, dname, init, std = spec
    shape = shape[(layer is not None) + (expert is not None):]
    dtype = _DT[dname]
    if init != "normal":
        return torch.full(shape, 1.0 if init == "ones" else 0.0,
                          dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed_mix(
        seed, zlib.crc32(path.encode()),
        0 if layer is None else layer + 1,
        0 if expert is None else expert + 1))
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def moe_leaves(arch: dict) -> set:
    """The paths of the routed experts' matrices."""
    return {f"{pfx}/ffn/{w}" for pfx, _i, _mix_kind, ffn in layer_sites(arch)
            if ffn == "moe" for w in EXPERT_LEAVES}


def make_params(arch: dict, seed: int, device, experts: range | None = None
                ) -> dict:
    """The flat ``{path: tensor}`` of a rank that holds ``experts`` (all
    by default) of every MoE layer, by :func:`draw`, each unit drawn
    into its place (no leaf is held twice)."""
    E = arch["moe"]["n_experts"]
    experts = range(E) if experts is None else experts
    specs = param_specs(arch, held=len(experts))
    routed = moe_leaves(arch)
    stacked = {f"group{g}" for g, (_p, reps) in enumerate(layer_groups(arch))
               if reps > 1}
    out = {}
    for path, spec in specs.items():
        t = out[path] = torch.empty(spec[0], dtype=_DT[spec[1]],
                                    device=device)
        for r in (range(spec[0][0]) if path.split("/")[0] in stacked
                  else [None]):
            at = t if r is None else t[r]
            if path in routed:
                for j, e in enumerate(experts):
                    at[j] = draw(spec, seed, path, r, e, device)
            else:
                at.copy_(draw(spec, seed, path, r, None, device))
    return out


# --------------------------------------------------------------------------
# the forward pass
# --------------------------------------------------------------------------

def yarn_inv_freq(rot: int, base: float, factor: float, orig: int,
                  fast: float, slow: float) -> torch.Tensor:
    """YaRN's inverse frequencies (float64): extrapolated (``base^(-2i/d)``)
    for the pairs that turn at least ``fast`` times over the original
    context, interpolated (that over ``factor``) for those that turn at
    most ``slow`` times, a linear ramp over the pair index between."""
    i = torch.arange(0, rot, 2, dtype=torch.float64)
    extra = 1.0 / base ** (i / rot)
    if factor <= 1:
        return extra

    def pair(turns):
        return rot * math.log(orig / (turns * 2 * math.pi)) \
            / (2 * math.log(base))
    lo, hi = max(math.floor(pair(fast)), 0), min(math.ceil(pair(slow)),
                                                 rot - 1)
    ramp = ((torch.arange(rot // 2, dtype=torch.float64) - lo)
            / (hi - lo if hi != lo else 0.001)).clamp(0, 1)
    return extra / factor * ramp + extra * (1 - ramp)


class DeepSeekV2Ref:
    """The reference over the weights of ``seed``, drawn layer by layer
    on ``device`` (module doc)."""

    def __init__(self, arch: dict, seed: int, device,
                 precision: str = Precision.F32, norm_eps: float = 1e-6):
        self.arch, self.seed, self.device = arch, seed, torch.device(device)
        self.precision, self.eps = precision, norm_eps
        self.specs = param_specs(arch)
        self.sites = layer_sites(arch)
        self.routed = moe_leaves(arch)

    # -- weights --------------------------------------------------------
    def weights(self, pfx: str, idx: int | None) -> dict:
        """Layer ``(pfx, idx)``'s leaves (name below ``pfx`` -> tensor);
        the routed experts' matrices with all E experts stacked."""
        E = self.arch["moe"]["n_experts"]
        out = {}
        for path, spec in self.specs.items():
            if not path.startswith(pfx + "/"):
                continue
            if path in self.routed:
                t = torch.stack([draw(spec, self.seed, path, idx, e,
                                      self.device) for e in range(E)])
            else:
                t = draw(spec, self.seed, path, idx, None, self.device)
            out[path[len(pfx) + 1:]] = t
        return out

    def leaf(self, path: str) -> torch.Tensor:
        return draw(self.specs[path], self.seed, path, None, None,
                    self.device).to(F32)

    # -- pieces ---------------------------------------------------------
    def q(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(F32)
        if self.precision == Precision.FP8:
            return q_fp8(t)
        if self.precision == BF16:
            return t.to(torch.bfloat16).to(F32)
        return t

    def lin(self, x, wt):
        return self.q(x) @ self.q(wt)

    def norm(self, x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * scale.to(F32)

    def rope(self, x, pos):
        """x (B, S, H, r): interleaved pairs rotated by YaRN's angles."""
        m = self.arch["mla"]
        yarn = m.get("yarn") or (1.0, 4096, 32.0, 1.0, 0.0)
        inv = yarn_inv_freq(m["rope_dim"], 10000.0, *yarn[:4])
        ang = pos.to(F32)[:, :, None] * inv.to(F32).to(x.device)
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack([a * cos - b * sin, b * cos + a * sin],
                           -1).flatten(-2)

    def softmax_scale(self) -> float:
        m = self.arch["mla"]
        s = 1.0 / math.sqrt(m["nope_dim"] + m["rope_dim"])
        yarn = m.get("yarn")
        if yarn is not None and yarn[0] > 1:
            s *= (0.1 * yarn[4] * math.log(yarn[0]) + 1.0) ** 2
        return s

    def attention(self, x, w, pos):
        m = self.arch["mla"]
        B, S, D = x.shape
        H, R, Dn = self.arch["n_heads"], m["kv_lora"], m["nope_dim"]
        cq = self.lin(x, w["mix/w_q_a"])
        if m.get("latent_norm"):
            cq = self.norm(cq, w["mix/q_norm/scale"])
        q = self.lin(cq, w["mix/w_q_b"].reshape(m["q_lora"], -1)) \
            .view(B, S, H, -1)
        q_nope, q_pe = q[..., :Dn], self.rope(q[..., Dn:], pos)
        c = self.lin(x, w["mix/w_kv_a"])
        ckv, k_pe = c[..., :R], self.rope(c[:, :, None, R:], pos)[:, :, 0]
        if m.get("latent_norm"):
            ckv = self.norm(ckv, w["mix/kv_norm/scale"])
        qc = self.q(ckv)
        k_nope = torch.einsum("bsr,hrk->bshk", qc, self.q(w["mix/w_uk"]))
        v = torch.einsum("bsr,hrv->bshv", qc, self.q(w["mix/w_uv"]))
        scale = self.softmax_scale()
        ctx = torch.empty(B, S, H, m["v_dim"], dtype=F32, device=x.device)
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=x.device).tril()
        for b in range(B):
            sc = (torch.einsum("shk,thk->hst", q_nope[b], k_nope[b])
                  + torch.einsum("shk,tk->hst", q_pe[b], k_pe[b])) * scale
            pr = torch.where(causal, sc, _NEG).softmax(-1)
            ctx[b] = torch.einsum("hst,thv->shv", pr, v[b])
            del sc, pr
        return self.lin(ctx.reshape(B, S, -1),
                        w["mix/w_o"].reshape(-1, D))

    def swiglu(self, x, w_in, w_out):
        h = self.lin(x, w_in.reshape(w_in.shape[0], -1)) \
            .view(*x.shape[:-1], 2, w_in.shape[-1])
        return self.lin(F.silu(h[..., 0, :]) * h[..., 1, :], w_out)

    def capacity(self, T: int) -> int:
        m = self.arch["moe"]
        return min(T, max(math.ceil(T * m["top_k"] * m["capacity_factor"]
                                    / m["n_experts"]), 8))

    def route(self, xt, w_router):
        """(gates (n, k), expert ids (n, k)) by group-limited greedy
        routing (module doc)."""
        m = self.arch["moe"]
        E, K = m["n_experts"], m["top_k"]
        ng, tg = m.get("n_group", 1), m.get("topk_group", 1)
        p = (xt @ w_router.to(F32)).softmax(-1)
        best = p.view(-1, ng, E // ng).amax(-1)
        keep = torch.zeros_like(best, dtype=torch.bool).scatter_(
            1, best.topk(tg, dim=-1).indices, True)
        gate, eid = p.masked_fill(~keep.repeat_interleave(E // ng, 1), 0.0) \
            .topk(K, dim=-1)
        if m.get("norm_topk", True):
            return gate / gate.sum(-1, keepdim=True), eid
        return gate * m.get("routed_scale", 1.0), eid

    def moe(self, x, w, groups: str, experts: range | None = None):
        """The routed experts of ``experts`` (all by default) over the
        routing groups of ``groups``: (B, S, D)."""
        m = self.arch["moe"]
        B, S, D = x.shape
        E, K = m["n_experts"], m["top_k"]
        xt = (x if groups == "sequence" else x.transpose(0, 1)) \
            .reshape(-1, D)
        Tg = B * S if groups == "sequence" else B
        gate, eid = self.route(xt, w["ffn/w_router"])
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
        keep = (rank < self.capacity(Tg)).view(n, K)
        y = torch.zeros_like(xt)
        for e in (range(E) if experts is None else experts):
            tok, kk = torch.nonzero((eid == e) & keep, as_tuple=True)
            if tok.numel():
                out = self.swiglu(xt[tok], w["ffn/w_in"][e],
                                  w["ffn/w_out"][e])
                y.index_add_(0, tok, out * gate[tok, kk, None])
        return (y.view(S, B, D).transpose(0, 1) if groups != "sequence"
                else y.view(B, S, D))

    def layer(self, resid, site, pos, groups, w: dict | None = None):
        """Layer ``site`` on ``resid``, over its weights ``w`` (drawn here
        where not given)."""
        pfx, idx, _mix_kind, ffn = site
        w = self.weights(pfx, idx) if w is None else w
        x = self.norm(resid, w["norm1/scale"])
        resid = resid + self.attention(x, w, pos)
        x = self.norm(resid, w["norm2/scale"])
        if ffn == "dense":
            return resid + self.swiglu(x, w["ffn/w_in"], w["ffn/w_out"])
        y = self.moe(x, w, groups)
        if self.arch["moe"]["n_shared"]:
            y = y + self.swiglu(x, w["ffn/w_shared_in"],
                                w["ffn/w_shared_out"])
        return resid + y

    def forward(self, tokens: torch.Tensor, groups: str = "position",
                at: torch.Tensor | None = None) -> torch.Tensor:
        """Logits (B, S, vocab) of ``tokens`` (B, S) from position 0, or
        only at the positions ``at`` (a (B, S) bool mask: (n, vocab))."""
        return forward_all([self], tokens, groups, at)[0]


def forward_all(refs: list, tokens: torch.Tensor, groups: str = "position",
                at: torch.Tensor | None = None) -> list:
    """``DeepSeekV2Ref.forward`` of each of ``refs`` (one arch and seed,
    any precisions), each layer's weights drawn once for all of them."""
    first = refs[0]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    embed = first.leaf("embed")[tokens]
    resid = [embed.clone() for _ in refs[1:]] + [embed]
    del embed
    for site in first.sites:
        w = first.weights(site[0], site[1])
        resid = [r.layer(h, site, pos, groups, w)
                 for r, h in zip(refs, resid)]
        del w
    scale, head = first.leaf("final_norm/scale"), first.leaf("head")
    out = []
    for r in refs:
        h = resid.pop(0)
        if at is not None:
            h = h[at]
        out.append(r.lin(r.norm(h, scale), head))
        del h
    return out
