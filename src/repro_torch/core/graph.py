"""Model → Functional dataflow graph extraction.

Builds the HIDA-IR Functional graph for one *representative super-block*
of an architecture (the smallest repeating layer pattern, e.g. Jamba's
period-8 Mamba/attention group) plus the embedding and LM-head stages.
Because every repetition of the super-block is isomorphic, HIDA-OPT's plan
for the representative block applies to all layers (the models scan over
stacked parameters); ``Graph`` carries ``repeat_factor`` so the estimator
reports absolute per-step numbers.

Buffer names follow ``L{j}__{role}`` so ``build_plan`` can expose
per-role sharding sites (``qkv``, ``attn_ctx``, ``ffn_hidden``,
``moe_dispatched``, ``residual`` …) that the JAX models reference at their
``with_sharding_constraint`` sites.

All loop-dim names are drawn from a fixed vocabulary (batch, seq, kv_seq,
heads, kv_heads, d_head, d_model, d_ff, experts, cap, vocab, d_state,
d_inner, img_seq, kv_lora, q_lora) — the connection analysis aligns them
across nodes exactly like the paper's permutation maps align loop levels.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ArchConfig, ShapeSpec
from .ir import AccessMap, Graph, TensorValue

BF = "bf16"


@dataclass
class GraphMeta:
    repeat_factor: int = 1
    layer_counts: dict[str, int] | None = None


def _mm(g: Graph, name: str, x: str, w: str, out: str,
        loop_dims: dict[str, int], flops: int, **attrs):
    return g.op("matmul", [x, w], [out], loop_dims, flops=flops,
                name=name, **attrs)


def _ew(g: Graph, name: str, ins: list[str], out: str,
        loop_dims: dict[str, int], flops_per_elem: int = 1, kind: str =
        "elementwise", **attrs):
    n = 1
    for v in loop_dims.values():
        n *= v
    if kind == "norm":
        attrs.setdefault("reduce", ("d_model",))
    return g.op(kind, ins, [out], loop_dims, flops=n * flops_per_elem,
                name=name, **attrs)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _attn_block(g: Graph, pre: str, cfg: ArchConfig, resid: str,
                B: int, S: int, KV: int, decode: bool,
                cross_kv: str | None = None) -> str:
    D, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    eff_kv = min(KV, cfg.attn_window) if cfg.attn_window else KV

    xn = g.tensor(f"{pre}__attn_norm", (B, S, D), BF,
                  ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_norm1", [resid], xn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm")

    wq = g.tensor(f"{pre}__w_q", (D, H, Dh), BF,
                  ("d_model", "heads", "d_head"), is_weight=True)
    q = g.tensor(f"{pre}__q", (B, S, H, Dh), BF,
                 ("batch", "seq", "heads", "d_head"))
    _mm(g, f"{pre}_q_proj", xn.name, wq.name, q.name,
        {"batch": B, "seq": S, "d_model": D, "heads": H, "d_head": Dh},
        2 * B * S * D * H * Dh)

    kv_src = cross_kv or xn.name
    kv_len = g.values[kv_src].shape[1] if cross_kv else S
    wkv = g.tensor(f"{pre}__w_kv", (D, 2, KVH, Dh), BF,
                   ("d_model", "two", "kv_heads", "d_head"), is_weight=True)
    k = g.tensor(f"{pre}__k", (B, kv_len, KVH, Dh), BF,
                 ("batch", "kv_seq", "kv_heads", "d_head"))
    v = g.tensor(f"{pre}__v", (B, kv_len, KVH, Dh), BF,
                 ("batch", "kv_seq", "kv_heads", "d_head"))
    g.op("matmul", [kv_src, wkv.name], [k.name, v.name],
         {"batch": B, "kv_seq": kv_len, "d_model": D, "kv_heads": KVH,
          "d_head": Dh},
         flops=2 * 2 * B * kv_len * D * KVH * Dh,
         name=f"{pre}_kv_proj",
         access={kv_src: AccessMap.of(("batch", 1), ("kv_seq", 1),
                                      (None, 1))})

    if decode and cross_kv is None:
        cache_k = g.tensor(f"{pre}__kv_cache_k", (B, KV, KVH, Dh), BF,
                           ("batch", "kv_seq", "kv_heads", "d_head"))
        cache_v = g.tensor(f"{pre}__kv_cache_v", (B, KV, KVH, Dh), BF,
                           ("batch", "kv_seq", "kv_heads", "d_head"))
        g.inputs += [cache_k.name, cache_v.name]
        # Two writers of the cache (k-update, v-update) → the
        # multi-producer pass legalises this (Alg. 3).
        g.op("cache_update", [k.name, cache_k.name], [cache_k.name],
             {"batch": B, "kv_heads": KVH, "d_head": Dh},
             name=f"{pre}_cache_k_upd")
        g.op("cache_update", [v.name, cache_v.name], [cache_v.name],
             {"batch": B, "kv_heads": KVH, "d_head": Dh},
             name=f"{pre}_cache_v_upd")
        k_use, v_use, att_kv = cache_k.name, cache_v.name, eff_kv
    else:
        k_use, v_use, att_kv = k.name, v.name, (eff_kv if not cross_kv
                                                else kv_len)

    ctx = g.tensor(f"{pre}__attn_ctx", (B, S, H, Dh), BF,
                   ("batch", "seq", "heads", "d_head"))
    g.op("attention", [q.name, k_use, v_use], [ctx.name],
         {"batch": B, "seq": S, "kv_seq": att_kv, "heads": H,
          "d_head": Dh},
         flops=4 * B * H * S * att_kv * Dh,
         name=f"{pre}_attention",
         window=cfg.attn_window,
         reduce=("d_head",),  # QK^T contracts d_head (kv_seq is inferred)
         access={
             q.name: AccessMap.of(("batch", 1), ("seq", 1), ("heads", 1),
                                  ("d_head", 1)),
             k_use: AccessMap.of(("batch", 1), ("kv_seq", 1),
                                 ("kv_heads", 1), ("d_head", 1)),
             v_use: AccessMap.of(("batch", 1), ("kv_seq", 1),
                                 ("kv_heads", 1), ("d_head", 1)),
         })

    wo = g.tensor(f"{pre}__w_o", (H, Dh, D), BF,
                  ("heads", "d_head", "d_model"), is_weight=True)
    attn_out = g.tensor(f"{pre}__attn_out", (B, S, D), BF,
                        ("batch", "seq", "d_model"))
    _mm(g, f"{pre}_o_proj", ctx.name, wo.name, attn_out.name,
        {"batch": B, "seq": S, "heads": H, "d_head": Dh, "d_model": D},
        2 * B * S * H * Dh * D)

    out = g.tensor(f"{pre}__residual", (B, S, D), BF,
                   ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_resid_add", [resid, attn_out.name], out.name,
        {"batch": B, "seq": S, "d_model": D}, 1, kind="residual")
    return out.name


def _mla_block(g: Graph, pre: str, cfg: ArchConfig, resid: str,
               B: int, S: int, KV: int, decode: bool) -> str:
    """DeepSeek MLA: low-rank Q and joint-KV compression; the decode cache
    holds only (kv_lora + rope_dim) per token."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    nope, rope, vdim = m.nope_dim, m.rope_dim, m.v_dim

    xn = g.tensor(f"{pre}__attn_norm", (B, S, D), BF,
                  ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_norm1", [resid], xn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm")

    wqa = g.tensor(f"{pre}__w_q_a", (D, m.q_lora), BF,
                   ("d_model", "q_lora"), is_weight=True)
    qa = g.tensor(f"{pre}__q_lora", (B, S, m.q_lora), BF,
                  ("batch", "seq", "q_lora"))
    _mm(g, f"{pre}_q_down", xn.name, wqa.name, qa.name,
        {"batch": B, "seq": S, "d_model": D, "q_lora": m.q_lora},
        2 * B * S * D * m.q_lora)
    wqb = g.tensor(f"{pre}__w_q_b", (m.q_lora, H, nope + rope), BF,
                   ("q_lora", "heads", "d_head"), is_weight=True)
    q = g.tensor(f"{pre}__q", (B, S, H, nope + rope), BF,
                 ("batch", "seq", "heads", "d_head"))
    _mm(g, f"{pre}_q_up", qa.name, wqb.name, q.name,
        {"batch": B, "seq": S, "q_lora": m.q_lora, "heads": H,
         "d_head": nope + rope},
        2 * B * S * m.q_lora * H * (nope + rope))

    wkva = g.tensor(f"{pre}__w_kv_a", (D, m.kv_lora + rope), BF,
                    ("d_model", "kv_lora"), is_weight=True)
    ckv = g.tensor(f"{pre}__c_kv", (B, S, m.kv_lora + rope), BF,
                   ("batch", "kv_seq", "kv_lora"))
    _mm(g, f"{pre}_kv_down", xn.name, wkva.name, ckv.name,
        {"batch": B, "kv_seq": S, "d_model": D,
         "kv_lora": m.kv_lora + rope},
        2 * B * S * D * (m.kv_lora + rope),
        access={xn.name: AccessMap.of(("batch", 1), ("kv_seq", 1),
                                      (None, 1))})

    if decode:
        cache = g.tensor(f"{pre}__kv_cache", (B, KV, m.kv_lora + rope), BF,
                         ("batch", "kv_seq", "kv_lora"))
        g.inputs.append(cache.name)
        g.op("cache_update", [ckv.name, cache.name], [cache.name],
             {"batch": B, "kv_lora": m.kv_lora + rope},
             name=f"{pre}_cache_upd")
        kv_use, att_kv = cache.name, KV
    else:
        kv_use, att_kv = ckv.name, S

    # Absorbed attention over the latent cache: score/combine FLOPs scale
    # with (kv_lora+rope), plus per-head absorb projections.
    ctx = g.tensor(f"{pre}__attn_ctx", (B, S, H, m.kv_lora), BF,
                   ("batch", "seq", "heads", "kv_lora"))
    wuk = g.tensor(f"{pre}__w_uk", (H, nope, m.kv_lora), BF,
                   ("heads", "d_head", "kv_lora"), is_weight=True)
    g.op("attention", [q.name, kv_use, wuk.name], [ctx.name],
         {"batch": B, "seq": S, "kv_seq": att_kv, "heads": H,
          "kv_lora": m.kv_lora + rope},
         flops=(2 * B * S * H * nope * m.kv_lora          # q absorb
                + 4 * B * H * S * att_kv * (m.kv_lora + rope)),
         name=f"{pre}_attention",
         access={
             q.name: AccessMap.of(("batch", 1), ("seq", 1), ("heads", 1),
                                  (None, 1)),
             kv_use: AccessMap.of(("batch", 1), ("kv_seq", 1),
                                  ("kv_lora", 1)),
             wuk.name: AccessMap.of(("heads", 1), (None, 1),
                                    ("kv_lora", 1)),
         })

    wuv = g.tensor(f"{pre}__w_uv_o", (H, m.kv_lora, D), BF,
                   ("heads", "kv_lora", "d_model"), is_weight=True)
    attn_out = g.tensor(f"{pre}__attn_out", (B, S, D), BF,
                        ("batch", "seq", "d_model"))
    _mm(g, f"{pre}_o_proj", ctx.name, wuv.name, attn_out.name,
        {"batch": B, "seq": S, "heads": H, "kv_lora": m.kv_lora,
         "d_model": D},
        2 * B * S * H * m.kv_lora * D)

    out = g.tensor(f"{pre}__residual", (B, S, D), BF,
                   ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_resid_add", [resid, attn_out.name], out.name,
        {"batch": B, "seq": S, "d_model": D}, 1, kind="residual")
    return out.name


def _mamba_block(g: Graph, pre: str, cfg: ArchConfig, resid: str,
                 B: int, S: int, decode: bool) -> str:
    mb = cfg.mamba
    D = cfg.d_model
    Din = mb.expand * D
    N = mb.d_state

    xn = g.tensor(f"{pre}__mix_norm", (B, S, D), BF,
                  ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_norm1", [resid], xn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm")

    w_in = g.tensor(f"{pre}__w_in", (D, 2 * Din), BF,
                    ("d_model", "d_inner"), is_weight=True)
    xz = g.tensor(f"{pre}__xz", (B, S, 2 * Din), BF,
                  ("batch", "seq", "d_inner"))
    _mm(g, f"{pre}_in_proj", xn.name, w_in.name, xz.name,
        {"batch": B, "seq": S, "d_model": D, "d_inner": 2 * Din},
        2 * B * S * D * 2 * Din)

    conv = g.tensor(f"{pre}__conv", (B, S, Din), BF,
                    ("batch", "seq", "d_inner"))
    g.op("conv", [xz.name], [conv.name],
         {"batch": B, "seq": S, "d_inner": Din},
         flops=2 * B * S * Din * mb.d_conv, name=f"{pre}_conv1d")

    w_xp = g.tensor(f"{pre}__w_xproj", (Din, 2 * N + 16), BF,
                    ("d_inner", "d_state"), is_weight=True)
    bcd = g.tensor(f"{pre}__bcdt", (B, S, 2 * N + 16), BF,
                   ("batch", "seq", "d_state"))
    _mm(g, f"{pre}_x_proj", conv.name, w_xp.name, bcd.name,
        {"batch": B, "seq": S, "d_inner": Din, "d_state": 2 * N + 16},
        2 * B * S * Din * (2 * N + 16))

    if decode:
        state = g.tensor(f"{pre}__ssm_state", (B, Din, N), "f32",
                         ("batch", "d_inner", "d_state"))
        g.inputs.append(state.name)
        y = g.tensor(f"{pre}__scan_out", (B, S, Din), BF,
                     ("batch", "seq", "d_inner"))
        g.op("scan", [conv.name, bcd.name, state.name],
             [y.name, state.name],
             {"batch": B, "d_inner": Din, "d_state": N},
             flops=6 * B * Din * N, name=f"{pre}_ssm_step")
    else:
        y = g.tensor(f"{pre}__scan_out", (B, S, Din), BF,
                     ("batch", "seq", "d_inner"))
        g.op("scan", [conv.name, bcd.name], [y.name],
             {"batch": B, "seq": S, "d_inner": Din, "d_state": N},
             flops=6 * B * S * Din * N, name=f"{pre}_ssm_scan",
             chunk=mb.chunk)

    w_out = g.tensor(f"{pre}__w_out", (Din, D), BF,
                     ("d_inner", "d_model"), is_weight=True)
    mix_out = g.tensor(f"{pre}__mix_out", (B, S, D), BF,
                       ("batch", "seq", "d_model"))
    _mm(g, f"{pre}_out_proj", y.name, w_out.name, mix_out.name,
        {"batch": B, "seq": S, "d_inner": Din, "d_model": D},
        2 * B * S * Din * D)

    out = g.tensor(f"{pre}__residual", (B, S, D), BF,
                   ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_resid_add", [resid, mix_out.name], out.name,
        {"batch": B, "seq": S, "d_model": D}, 1, kind="residual")
    return out.name


def _xlstm_block(g: Graph, pre: str, cfg: ArchConfig, resid: str,
                 B: int, S: int, kind: str, decode: bool) -> str:
    x = cfg.xlstm
    D = cfg.d_model
    xn = g.tensor(f"{pre}__mix_norm", (B, S, D), BF,
                  ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_norm1", [resid], xn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm")

    if kind == "mlstm":
        Din = x.proj_factor_mlstm * D
        w_up = g.tensor(f"{pre}__w_up", (D, 2 * Din), BF,
                        ("d_model", "d_inner"), is_weight=True)
        up = g.tensor(f"{pre}__up", (B, S, 2 * Din), BF,
                      ("batch", "seq", "d_inner"))
        _mm(g, f"{pre}_up_proj", xn.name, w_up.name, up.name,
            {"batch": B, "seq": S, "d_model": D, "d_inner": 2 * Din},
            2 * B * S * D * 2 * Din)
        Dh = Din // cfg.n_heads
        y = g.tensor(f"{pre}__scan_out", (B, S, Din), BF,
                     ("batch", "seq", "d_inner"))
        flops = (4 * B * S * x.chunk * Din        # intra-chunk quadratic
                 + 8 * B * S * Din * Dh)          # inter-chunk state
        loop = {"batch": B, "seq": S, "heads": cfg.n_heads,
                "d_inner": Din}
        if decode:
            state = g.tensor(f"{pre}__mlstm_state",
                             (B, cfg.n_heads, Dh, Dh), "f32",
                             ("batch", "heads", "d_head", "d_head2"))
            g.inputs.append(state.name)
            g.op("scan", [up.name, state.name], [y.name, state.name],
                 {"batch": B, "heads": cfg.n_heads, "d_inner": Din},
                 flops=8 * B * Din * Dh, name=f"{pre}_mlstm_step")
        else:
            g.op("scan", [up.name], [y.name], loop, flops=flops,
                 name=f"{pre}_mlstm_chunk", chunk=x.chunk)
        w_dn = g.tensor(f"{pre}__w_down", (Din, D), BF,
                        ("d_inner", "d_model"), is_weight=True)
        mix = g.tensor(f"{pre}__mix_out", (B, S, D), BF,
                       ("batch", "seq", "d_model"))
        _mm(g, f"{pre}_down_proj", y.name, w_dn.name, mix.name,
            {"batch": B, "seq": S, "d_inner": Din, "d_model": D},
            2 * B * S * Din * D)
    else:  # slstm: sequence-sequential recurrence — seq is NOT shardable
        w_g = g.tensor(f"{pre}__w_gates", (D, 4 * D), BF,
                       ("d_model", "d_inner"), is_weight=True)
        gates = g.tensor(f"{pre}__gates", (B, S, 4 * D), BF,
                         ("batch", "seq", "d_inner"))
        _mm(g, f"{pre}_gate_proj", xn.name, w_g.name, gates.name,
            {"batch": B, "seq": S, "d_model": D, "d_inner": 4 * D},
            2 * B * S * D * 4 * D)
        y = g.tensor(f"{pre}__scan_out", (B, S, D), BF,
                     ("batch", "seq", "d_model"))
        g.op("scan", [gates.name], [y.name],
             {"batch": B, "seq": S, "heads": cfg.n_heads,
              "d_model": D},
             flops=20 * B * S * D, name=f"{pre}_slstm_scan",
             no_shard=("seq",))
        w_f = g.tensor(f"{pre}__w_ffn", (D, 2 * x.d_ff_slstm), BF,
                       ("d_model", "d_ff"), is_weight=True)
        w_f2 = g.tensor(f"{pre}__w_ffn2", (x.d_ff_slstm, D), BF,
                        ("d_ff", "d_model"), is_weight=True)
        h = g.tensor(f"{pre}__ffn_hidden", (B, S, x.d_ff_slstm), BF,
                     ("batch", "seq", "d_ff"))
        _mm(g, f"{pre}_ffn_in", y.name, w_f.name, h.name,
            {"batch": B, "seq": S, "d_model": D, "d_ff": x.d_ff_slstm},
            2 * B * S * D * 2 * x.d_ff_slstm)
        mix = g.tensor(f"{pre}__mix_out", (B, S, D), BF,
                       ("batch", "seq", "d_model"))
        _mm(g, f"{pre}_ffn_out", h.name, w_f2.name, mix.name,
            {"batch": B, "seq": S, "d_ff": x.d_ff_slstm, "d_model": D},
            2 * B * S * x.d_ff_slstm * D)

    out = g.tensor(f"{pre}__residual", (B, S, D), BF,
                   ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_resid_add", [resid, mix.name], out.name,
        {"batch": B, "seq": S, "d_model": D}, 1, kind="residual")
    return out.name


def _dense_ffn(g: Graph, pre: str, cfg: ArchConfig, resid: str,
               B: int, S: int, d_ff: int) -> str:
    D = cfg.d_model
    xn = g.tensor(f"{pre}__ffn_norm", (B, S, D), BF,
                  ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_norm2", [resid], xn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm")
    w_in = g.tensor(f"{pre}__w_ffn_in", (D, 2, d_ff), BF,
                    ("d_model", "two", "d_ff"), is_weight=True)
    h = g.tensor(f"{pre}__ffn_hidden", (B, S, d_ff), BF,
                 ("batch", "seq", "d_ff"))
    _mm(g, f"{pre}_ffn_in", xn.name, w_in.name, h.name,
        {"batch": B, "seq": S, "d_model": D, "d_ff": d_ff},
        2 * B * S * D * 2 * d_ff)
    ha = g.tensor(f"{pre}__ffn_act", (B, S, d_ff), BF,
                  ("batch", "seq", "d_ff"))
    _ew(g, f"{pre}_swiglu", [h.name], ha.name,
        {"batch": B, "seq": S, "d_ff": d_ff}, 4, kind="activation")
    w_out = g.tensor(f"{pre}__w_ffn_out", (d_ff, D), BF,
                     ("d_ff", "d_model"), is_weight=True)
    f = g.tensor(f"{pre}__ffn_out", (B, S, D), BF,
                 ("batch", "seq", "d_model"))
    _mm(g, f"{pre}_ffn_out", ha.name, w_out.name, f.name,
        {"batch": B, "seq": S, "d_ff": d_ff, "d_model": D},
        2 * B * S * d_ff * D)
    out = g.tensor(f"{pre}__residual2", (B, S, D), BF,
                   ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_resid_add2", [resid, f.name], out.name,
        {"batch": B, "seq": S, "d_model": D}, 1, kind="residual")
    return out.name


def _moe_ffn(g: Graph, pre: str, cfg: ArchConfig, resid: str,
             B: int, S: int) -> str:
    moe = cfg.moe
    D, E, K = cfg.d_model, moe.n_experts, moe.top_k
    Fe = moe.d_expert
    tokens = B * S
    cap = max(1, int(tokens * K * moe.capacity_factor) // E)

    xn = g.tensor(f"{pre}__ffn_norm", (B, S, D), BF,
                  ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_norm2", [resid], xn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm")

    w_r = g.tensor(f"{pre}__w_router", (D, E), "f32",
                   ("d_model", "experts"), is_weight=True)
    logits = g.tensor(f"{pre}__router_logits", (B, S, E), "f32",
                      ("batch", "seq", "experts"))
    _mm(g, f"{pre}_router", xn.name, w_r.name, logits.name,
        {"batch": B, "seq": S, "d_model": D, "experts": E},
        2 * B * S * D * E)
    g.values[f"{pre}_router_op_marker"] = TensorValue(
        f"{pre}_router_op_marker", (1,), "f32")  # placeholder (unused)

    disp = g.tensor(f"{pre}__moe_dispatched", (E, cap, D), BF,
                    ("experts", "cap", "d_model"))
    g.op("moe_dispatch", [xn.name, logits.name], [disp.name],
         {"experts": E, "cap": cap, "d_model": D},
         flops=tokens * K * D, name=f"{pre}_dispatch",
         access={xn.name: AccessMap.of(("batch", 1), (None, 1), ("d_model", 1)),
                 logits.name: AccessMap.of(("batch", 1), (None, 1),
                                           ("experts", 1))})

    w_e1 = g.tensor(f"{pre}__w_exp_in", (E, D, 2, Fe), BF,
                    ("experts", "d_model", "two", "d_ff"), is_weight=True)
    eh = g.tensor(f"{pre}__expert_hidden", (E, cap, Fe), BF,
                  ("experts", "cap", "d_ff"))
    _mm(g, f"{pre}_expert_in", disp.name, w_e1.name, eh.name,
        {"experts": E, "cap": cap, "d_model": D, "d_ff": Fe},
        2 * E * cap * D * 2 * Fe)
    w_e2 = g.tensor(f"{pre}__w_exp_out", (E, Fe, D), BF,
                    ("experts", "d_ff", "d_model"), is_weight=True)
    eo = g.tensor(f"{pre}__expert_out", (E, cap, D), BF,
                  ("experts", "cap", "d_model"))
    _mm(g, f"{pre}_expert_out", eh.name, w_e2.name, eo.name,
        {"experts": E, "cap": cap, "d_ff": Fe, "d_model": D},
        2 * E * cap * Fe * D)

    comb = g.tensor(f"{pre}__moe_out", (B, S, D), BF,
                    ("batch", "seq", "d_model"))
    g.op("moe_combine", [eo.name, logits.name], [comb.name],
         {"batch": B, "seq": S, "d_model": D},
         flops=tokens * K * D, name=f"{pre}_combine",
         access={eo.name: AccessMap.of((None, 1), (None, 1),
                                       ("d_model", 1)),
                 logits.name: AccessMap.of(("batch", 1), ("seq", 1),
                                           (None, 1))})

    paths = [comb.name]
    if moe.n_shared:
        # Shared-expert path runs in parallel with routed dispatch — the
        # short/long path pair the balancing pass handles (Fig. 8).
        Fs = moe.n_shared * Fe
        w_s1 = g.tensor(f"{pre}__w_shared_in", (D, 2, Fs), BF,
                        ("d_model", "two", "d_ff"), is_weight=True)
        sh = g.tensor(f"{pre}__shared_hidden", (B, S, Fs), BF,
                      ("batch", "seq", "d_ff"))
        _mm(g, f"{pre}_shared_in", xn.name, w_s1.name, sh.name,
            {"batch": B, "seq": S, "d_model": D, "d_ff": Fs},
            2 * B * S * D * 2 * Fs)
        w_s2 = g.tensor(f"{pre}__w_shared_out", (Fs, D), BF,
                        ("d_ff", "d_model"), is_weight=True)
        so = g.tensor(f"{pre}__shared_out", (B, S, D), BF,
                      ("batch", "seq", "d_model"))
        _mm(g, f"{pre}_shared_out", sh.name, w_s2.name, so.name,
            {"batch": B, "seq": S, "d_ff": Fs, "d_model": D},
            2 * B * S * Fs * D)
        paths.append(so.name)

    out = g.tensor(f"{pre}__residual2", (B, S, D), BF,
                   ("batch", "seq", "d_model"))
    _ew(g, f"{pre}_resid_add2", [resid] + paths, out.name,
        {"batch": B, "seq": S, "d_model": D}, 1, kind="residual")
    return out.name


# --------------------------------------------------------------------------
# Full graph
# --------------------------------------------------------------------------

def step_flops(graph: Graph, mode: str) -> float:
    """Analytic whole-step FLOPs from the IR (op.flops × per-iteration
    repeat × super-block repeat count).  Used for the roofline compute
    term because XLA's cost analysis counts while-loop (layer-scan) bodies
    once regardless of trip count.  Training ≈ 3× forward."""
    r = graph.meta.repeat_factor  # type: ignore[attr-defined]
    fwd = sum(o.flops * o.repeat * r for o in graph.leaf_ops())
    return fwd * (3.0 if mode == "train" else 1.0)


def model_flops_6nd(cfg: ArchConfig, tokens: int) -> float:
    """The 6·N·D convention (6·N_active·D for MoE) for §Roofline."""
    # Active params: embed + per-layer weights with MoE counted at top-k.
    active = cfg.vocab * cfg.d_model
    for i in range(cfg.n_layers):
        mix, ffn = cfg.block_kind(i), cfg.ffn_kind(i)
        D = cfg.d_model
        if mix in ("attn", "xattn"):
            if cfg.mla is not None:
                m = cfg.mla
                active += (D * m.q_lora
                           + m.q_lora * cfg.n_heads * (m.nope_dim + m.rope_dim)
                           + D * (m.kv_lora + m.rope_dim)
                           + cfg.n_heads * m.kv_lora * (m.nope_dim + m.v_dim)
                           + cfg.n_heads * m.v_dim * D)
            else:
                Dh = cfg.resolved_head_dim
                active += D * Dh * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                    + cfg.n_heads * Dh * D
        elif mix == "mamba":
            mb = cfg.mamba
            Din = mb.expand * D
            active += D * 2 * Din + Din * D + Din * (2 * mb.d_state + 16)
        elif mix == "mlstm":
            Din = cfg.xlstm.proj_factor_mlstm * D
            active += D * 2 * Din + Din * 3 * Din + Din * D
        elif mix == "slstm":
            active += 8 * D * D + 3 * D * cfg.xlstm.d_ff_slstm
        if ffn == "dense":
            active += 3 * D * (cfg.dense_d_ff or cfg.d_ff)
        elif ffn == "moe":
            moe = cfg.moe
            active += (3 * D * moe.d_expert * (moe.top_k + moe.n_shared)
                       + D * moe.n_experts)
    if not cfg.tie_embeddings:
        active += cfg.d_model * cfg.vocab
    return 6.0 * active * tokens


def build_lm_graph(cfg: ArchConfig, shape: ShapeSpec) -> Graph:
    decode = shape.mode == "decode"
    B = shape.global_batch
    S = 1 if decode else shape.seq_len
    KV = shape.seq_len
    D, V = cfg.d_model, cfg.vocab

    g = Graph(name=f"{cfg.name}_{shape.name}")
    groups = cfg.layer_groups()
    pattern, repeats = max(groups, key=lambda gr: len(gr[0]) * gr[1])
    # Ops outside the repeated super-block run once per step, i.e. 1/repeats
    # per block iteration — amortize so balancing sees steady-state costs.
    amort = 1.0 / max(repeats, 1)

    # ---- frontend -----------------------------------------------------------
    if cfg.frontend == "audio_frames":
        resid = g.tensor("frames", (B, S, D), BF,
                         ("batch", "seq", "d_model"), is_input=True).name
    else:
        tokens = g.tensor("tokens", (B, S), "i32", ("batch", "seq"),
                          is_input=True)
        emb = g.tensor("emb_table", (V, D), BF, ("vocab", "d_model"),
                       is_weight=True)
        resid_t = g.tensor("embed_out", (B, S, D), BF,
                           ("batch", "seq", "d_model"))
        embed_op = g.op(
            "gather", [tokens.name, emb.name], [resid_t.name],
            {"batch": B, "seq": S, "d_model": D}, flops=0, name="embed",
            access={emb.name: AccessMap.of((None, 1), ("d_model", 1))})
        embed_op.repeat = amort
        resid = resid_t.name
    img = None
    if cfg.frontend == "vision":
        img = g.tensor("img_embeds", (B, cfg.n_img_tokens, D), BF,
                       ("batch", "kv_seq", "d_model"), is_input=True).name

    # ---- representative super-block ----------------------------------------
    for j, (mix, ffn) in enumerate(pattern):
        pre = f"L{j}_{mix}"
        if mix == "attn":
            if cfg.mla is not None:
                resid = _mla_block(g, pre, cfg, resid, B, S, KV, decode)
            else:
                resid = _attn_block(g, pre, cfg, resid, B, S, KV, decode)
        elif mix == "xattn":
            resid = _attn_block(g, pre, cfg, resid, B, S, KV, decode,
                                cross_kv=img)
        elif mix == "mamba":
            resid = _mamba_block(g, pre, cfg, resid, B, S, decode)
        elif mix in ("mlstm", "slstm"):
            resid = _xlstm_block(g, pre, cfg, resid, B, S, mix, decode)
        if ffn == "dense":
            resid = _dense_ffn(g, pre, cfg, resid, B, S,
                               cfg.dense_d_ff or cfg.d_ff)
        elif ffn == "moe":
            resid = _moe_ffn(g, pre, cfg, resid, B, S)

    # ---- head ----------------------------------------------------------------
    fn = g.tensor("final_norm", (B, S, D), BF, ("batch", "seq", "d_model"))
    _ew(g, "final_norm_op", [resid], fn.name,
        {"batch": B, "seq": S, "d_model": D}, 5, kind="norm").repeat = amort
    w_head = g.tensor("w_head", (D, V), BF, ("d_model", "vocab"),
                      is_weight=True)
    logits = g.tensor("logits", (B, S, V), BF, ("batch", "seq", "vocab"))
    _mm(g, "lm_head", fn.name, w_head.name, logits.name,
        {"batch": B, "seq": S, "d_model": D, "vocab": V},
        2 * B * S * D * V).repeat = amort

    if shape.mode == "train":
        labels = g.tensor("labels", (B, S), "i32", ("batch", "seq"),
                          is_input=True)
        loss = g.tensor("loss", (), "f32", ())
        g.op("loss", [logits.name, labels.name], [loss.name],
             {"batch": B, "seq": S, "vocab": V},
             flops=4 * B * S * V, name="xent").repeat = amort
        g.outputs = [loss.name]
    else:
        g.outputs = [logits.name]

    # Backward ≈ 2x forward for training — reflected in the estimator via
    # meta, not by duplicating the graph (plan is identical for fwd/bwd).
    g.meta = GraphMeta(  # type: ignore[attr-defined]
        repeat_factor=repeats,
        layer_counts={k: sum(1 for a, b in cfg.layer_kinds()
                             if a == k or b == k)
                      for k in ("attn", "xattn", "mamba", "mlstm", "slstm",
                                "dense", "moe")})
    return g
