"""Attention family: GQA self-attention with causal and sliding-window
masks, cross-attention over a context stream (``kv_x``, the vision
layers), the KV cache with scalar and per-slot positions, the
flash-attention kernel on the full-sequence path, and DeepSeek's MLA
with the absorbed decode form over the latent cache.

Counterpart of ``repro.models.attention``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.plan import attend, project, relayout
from .layers import (F32, ParamBuilder, apply_norm, apply_rope, rope_angles,
                     yarn_mscale)

Constrain = Callable[..., torch.Tensor]
_NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, KVH, Dh), or MLA's latent
                             # (B, S_max, kv_lora + rope_dim), v None
    v: Optional[torch.Tensor]
    #: tokens already cached: a scalar int32 for lock-step decode, or a
    #: per-slot ``(B,)`` int32 vector for the continuous-batching server.
    pos: torch.Tensor


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------

def init_gqa(pb: ParamBuilder, path: str, cfg: ArchConfig,
             stack: int | None = None) -> None:
    D, H, KV, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    pb.weight(f"{path}/w_q", (D, H, Dh), ("d_model", "heads", "d_head"),
              stack=stack)
    pb.weight(f"{path}/w_kv", (D, 2, KV, Dh),
              ("d_model", "two", "kv_heads", "d_head"), stack=stack)
    pb.weight(f"{path}/w_o", (H, Dh, D), ("heads", "d_head", "d_model"),
              stack=stack)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Skv,KVH,Dh) with GQA head grouping.

    Rounds where the reference rounds: the scores leave the q·k product
    in q's dtype before the f32 softmax, and the probabilities are cast
    back to q's dtype before the product with v."""
    B, Sq, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(F32)
    scores = scores / math.sqrt(Dh)
    if mask is not None:
        scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
    return ctx.reshape(B, Sq, H, v.shape[-1])


#: switch to the memory-linear chunked path above this many score elements
_FLASH_THRESHOLD = 1 << 21
_Q_BLOCK = 256
_KV_BLOCK = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_block: int = _Q_BLOCK, kv_block: int = _KV_BLOCK,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax chunked attention in plain PyTorch (the
    counterpart of ``flash_attention_jnp``): O(Sq·Dh) memory instead of
    O(Sq·Skv), all arithmetic in f32.  GQA grouping handled natively.
    ``q_offset`` is the position of q's first row (a rank's block of a
    split sequence; ``core.plan.attend``)."""
    B, Sq, H, Dh = q.shape
    KVH = k.shape[2]
    G = H // KVH
    Skv = k.shape[1]
    Dv = v.shape[-1]
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    nq, nk = Sq // q_block, Skv // kv_block
    if Sq % q_block or Skv % kv_block:
        return _sdpa(q, k, v, causal_mask(Sq, Skv, window, q_offset,
                                          device=q.device)
                     if causal else None)
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    dev = q.device

    qb = q.reshape(B, nq, q_block, KVH, G, Dh).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, nk, kv_block, KVH, Dh).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, kv_block, KVH, Dv).permute(1, 0, 3, 2, 4)
    ys = []
    for qi in range(nq):
        qblk = qb[qi].to(F32)
        qpos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((B, KVH, G, q_block), -math.inf, dtype=F32,
                       device=dev)
        l = torch.zeros((B, KVH, G, q_block), dtype=F32, device=dev)
        acc = torch.zeros((B, KVH, G, q_block, Dv), dtype=F32, device=dev)
        for ki in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                             kb[ki].to(F32)) * scale
            kpos = ki * kv_block + torch.arange(kv_block, device=dev)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb[ki].to(F32))
            m = m_new
        y = acc / torch.clamp(l, min=1e-30)[..., None]
        ys.append(y.to(q.dtype))
    # ys: (nq, B, KVH, G, q_block, Dv)
    out = torch.stack(ys).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, Dv)
    return out


def causal_mask(Sq: int, Skv: int, window: int | None = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """(1,1,1,Sq,Skv) boolean mask; ``window`` adds the SWA band."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None, None]


def decode_mask(Skv: int, pos: torch.Tensor, window: int | None = None
                ) -> torch.Tensor:
    """Single-token decode mask at position ``pos``: ``(1,1,1,1,Skv)``
    for scalar ``pos``, ``(B,1,1,1,Skv)`` for per-slot ``(B,)`` ``pos``
    (each slot attends only to its own prefix, so stale cache rows from
    a previous slot occupant get exactly zero probability)."""
    kpos = torch.arange(Skv, device=pos.device)
    if pos.ndim:
        m = kpos[None, :] <= pos[:, None]
        if window is not None:
            m = m & (kpos[None, :] > pos[:, None] - window)
        return m[:, None, None, None, :]
    m = kpos <= pos
    if window is not None:
        m = m & (kpos > pos - window)
    return m[None, None, None, None, :]


def _write_rows(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                active: torch.Tensor | None) -> None:
    """Write ``new`` (B, n, ...) into ``buf`` (B, S_c, ...) in place at
    ``pos``.  Per-slot positions scatter each row's first new row at its
    own position, an inactive row writing back what was there; a scalar
    position writes all ``n`` rows for every row, clamped to ``S_c - n``
    as the reference's ``dynamic_update_slice`` clamps it."""
    if pos.ndim:
        rows = torch.arange(new.shape[0], device=new.device)
        at = pos.long()
        row = new[:, 0]
        if active is not None:
            keep = active.view((-1,) + (1,) * (row.ndim - 1))
            row = torch.where(keep, row, buf[rows, at])
        buf[rows, at] = row
        return
    n = new.shape[1]
    start = torch.clamp(pos.long(), max=buf.shape[1] - n)
    buf.index_copy_(1, start + torch.arange(n, device=new.device), new)


def _write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor | None,
                 active: torch.Tensor | None) -> None:
    """Write this step's k/v (or MLA's latent row, ``v`` None) into the
    cache in place (saves a copy of the whole cache per layer per step;
    JAX returns a new one instead), as ``_write_rows`` does, so an
    inactive slot's cache stays bit-identical.  ``active`` needs per-slot
    positions; k with more rows than the cache raises, where the
    reference refuses to trace."""
    if not cache.pos.ndim:
        if active is not None:
            raise ValueError("active gating needs per-slot (vector) cache "
                             "positions: init_caches(vector_pos=True)")
        n, S_c = k.shape[1], cache.k.shape[1]
        if n > S_c:
            raise ValueError(f"cannot write {n} k/v rows into a cache of "
                             f"{S_c} positions (the reference's "
                             "dynamic_update_slice refuses it too): give "
                             "the cache at least as many positions as the "
                             "cross-attention context has rows")
    _write_rows(cache.k, k, cache.pos, active)
    if v is not None:
        _write_rows(cache.v, v, cache.pos, active)


def fill_slots(cache: KVCache, rows: KVCache, slots: torch.Tensor,
               lengths: torch.Tensor, axis: int = 0) -> None:
    """Write row ``i`` of a full sequence's k/v (``rows.k``, ``rows.v``:
    (n, S, KVH, Dh)) into slot ``slots[i]`` of a per-slot ``cache`` in
    place: its rows ``[0, lengths[i])``, zeros in the slot's rows past
    them, and position ``lengths[i]``, as that many gated decode steps
    from a zero cache leave it.  ``axis`` is the batch axis: 1 inside a
    stacked group, whose leading axis (layers) both trees share."""
    S = rows.k.shape[axis + 1]
    keep = (torch.arange(S, device=slots.device) < lengths[:, None]
            )[..., None, None]
    at = (slice(None),) * axis + (slots,)
    for buf, new in ((cache.k, rows.k), (cache.v, rows.v)):
        buf.index_fill_(axis, slots, 0)
        buf[at + (slice(0, S),)] = torch.where(keep, new, 0)
    cache.pos[at] = lengths.to(cache.pos.dtype)


def gqa_attention(x: torch.Tensor, p: dict, cfg: ArchConfig,
                  positions: torch.Tensor, constrain: Constrain,
                  cache: KVCache | None = None,
                  kv_x: torch.Tensor | None = None,
                  causal: bool = True,
                  use_kernels: bool = False,
                  active: torch.Tensor | None = None,
                  keep_kv: bool = False,
                  ) -> tuple[torch.Tensor, KVCache | None]:
    """Self- or cross-attention.  ``cache`` implies single-step decode
    (``active`` gates its per-slot write); without a cache ``use_kernels``
    runs the flash-attention kernel, and ``keep_kv`` returns the full
    sequence's post-RoPE k/v rows as ``KVCache(k, v, None)`` (for
    ``fill_slots``).  ``kv_x`` switches to cross-attention over a context
    stream: k/v from ``kv_x``, no RoPE, no causal mask.

    With a cache, cross-attention does what the reference's does: it
    projects all of ``kv_x`` and writes it into the layer's KV cache like
    self-attention's k/v, so decode attends to the cache rows ``<= pos``
    (per-slot: context row 0 at each slot's ``pos``; scalar: every
    context row from the clamped ``pos``; see ``_write_cache``)."""
    B, S, D = x.shape
    Dh = cfg.resolved_head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    rot_dim = int(Dh * cfg.rope_pct) & ~1

    src = kv_x if kv_x is not None else x
    q = project(x, p["w_q"], 1, constrain,
                ("batch", "seq", "heads", "d_head"), "q")
    kv = project(src, p["w_kv"], 1, constrain,
                 ("batch", "kv_seq", None, "kv_heads", "d_head"))
    k, v = kv[:, :, 0], kv[:, :, 1]
    k = constrain(k, ("batch", "kv_seq", "kv_heads", "d_head"), "k")
    v = constrain(v, ("batch", "kv_seq", "kv_heads", "d_head"), "v")

    if kv_x is None and rot_dim > 0:
        cos, sin = rope_angles(positions, rot_dim)
        q = apply_rope(q, cos, sin, rot_dim)
        k = apply_rope(k, cos, sin, rot_dim)

    new_cache = None
    if cache is not None:
        _write_cache(cache, k, v, active)
        new_cache = KVCache(cache.k, cache.v, cache.pos + S)
        mask = decode_mask(cache.k.shape[1], cache.pos, cfg.attn_window)
        ctx = _sdpa(q, cache.k, cache.v, mask)
    else:
        if keep_kv:
            new_cache = KVCache(k, v, None)
        is_causal = causal and kv_x is None
        if use_kernels:
            from ..kernels.flash_attention import ops as fa_ops
            ctx = fa_ops.mha(q, k, v, causal=is_causal,
                             window=cfg.attn_window)
        else:
            chunked = S * k.shape[1] > _FLASH_THRESHOLD

            def core(q, k, v, q_offset):
                if chunked:
                    return flash_attention(q, k, v, causal=is_causal,
                                           window=cfg.attn_window,
                                           q_offset=q_offset)
                mask = (causal_mask(q.shape[1], k.shape[1], cfg.attn_window,
                                    q_offset, device=x.device)
                        if is_causal else None)
                return _sdpa(q, k, v, mask)
            ctx = attend(core, q, k, v)

    ctx = constrain(ctx, ("batch", "seq", "heads", "d_head"), "attn_ctx")
    return project(ctx, p["w_o"], 2), new_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek V2/V3)
# --------------------------------------------------------------------------

def init_mla(pb: ParamBuilder, path: str, cfg: ArchConfig,
             stack: int | None = None) -> None:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    pb.weight(f"{path}/w_q_a", (D, m.q_lora), ("d_model", "q_lora"),
              stack=stack)
    pb.weight(f"{path}/w_q_b", (m.q_lora, H, m.nope_dim + m.rope_dim),
              ("q_lora", "heads", "d_head"), stack=stack)
    pb.weight(f"{path}/w_kv_a", (D, m.kv_lora + m.rope_dim),
              ("d_model", "kv_lora"), stack=stack)
    pb.weight(f"{path}/w_uk", (H, m.kv_lora, m.nope_dim),
              ("heads", "kv_lora", "d_head"), stack=stack)
    pb.weight(f"{path}/w_uv", (H, m.kv_lora, m.v_dim),
              ("heads", "kv_lora", "d_head"), stack=stack)
    pb.weight(f"{path}/w_o", (H, m.v_dim, D),
              ("heads", "d_head", "d_model"), stack=stack)
    if m.latent_norm:
        pb.ones(f"{path}/q_norm/scale", (m.q_lora,), ("q_lora",),
                stack=stack)
        pb.ones(f"{path}/kv_norm/scale", (m.kv_lora,), ("kv_lora",),
                stack=stack)


def mla_rope(m) -> tuple[tuple | None, float]:
    """(YaRN's parameters for ``layers.rope_angles``, or ``None`` for
    plain RoPE; the factor YaRN multiplies the softmax scale by, the
    square of its attention factor at ``mscale_all_dim``, which
    DeepSeek-V2's code applies to the scale)."""
    if m.yarn is None:
        return None, 1.0
    ms = yarn_mscale(m.yarn[0], m.yarn[4])
    return m.yarn, ms * ms


def mla_attention(x: torch.Tensor, p: dict, cfg: ArchConfig,
                  positions: torch.Tensor, constrain: Constrain,
                  cache: KVCache | None = None,
                  active: torch.Tensor | None = None,
                  use_kernels: bool = False,
                  ) -> tuple[torch.Tensor, KVCache | None]:
    """MLA with the latent cache.  Without a cache the keys and values are
    materialised per head (in f32 where ``S·S`` is at most
    ``_FLASH_THRESHOLD``, else through the chunked ``flash_attention`` in
    bf16 with Dqk 192 and Dv 128); with one, decode runs the *absorbed*
    form: the queries are projected into the latent space, so the cache
    holds ``kv_lora + rope_dim`` features a token, written in place as
    ``_write_cache`` writes (``active`` gates per-slot rows).

    Where the reference asks for an f32 result of bf16 operands
    (``preferred_element_type=F32``) the operands are cast to f32 and
    multiplied in f32, where the products of bf16 values are exact.

    Port-only, under ``MLAConfig`` fields whose defaults leave all of the
    above as it is (DeepSeek-V2 as published, arXiv:2405.04434):
    ``latent_norm`` RMS-normalises the compressed query ``x @ w_q_a`` and
    the latent's first ``kv_lora`` features (not its rope part) before
    they are used or cached, through the RMSNorm kernel under
    ``use_kernels``; ``yarn`` gives the rope YaRN's
    frequencies and multiplies the softmax scale by ``mla_rope``'s
    factor."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    R, Dn = m.kv_lora, m.nope_dim

    def norm(t, key):
        return apply_norm("rms", t, p[key], use_kernels) if m.latent_norm \
            else t

    qa = norm(x @ p["w_q_a"], "q_norm")
    q = (qa @ p["w_q_b"].reshape(m.q_lora, -1)).reshape(B, S, H, -1)
    q_nope, q_pe = q[..., :Dn], q[..., Dn:]
    ckv_full = x @ p["w_kv_a"]
    q_nope = constrain(q_nope, ("batch", "seq", "heads", "d_head"), "q")
    ckv_full = constrain(ckv_full, ("batch", "kv_seq", "kv_lora"), "c_kv")

    yarn, scale_mult = mla_rope(m)
    cos, sin = rope_angles(positions, m.rope_dim, yarn=yarn)
    q_pe = apply_rope(q_pe, cos, sin, m.rope_dim)
    k_pe = apply_rope(ckv_full[:, :, None, R:], cos, sin,
                      m.rope_dim)[:, :, 0]
    ckv = torch.cat([norm(ckv_full[..., :R], "kv_norm"), k_pe], dim=-1)
    scale = math.sqrt(Dn + m.rope_dim)
    if scale_mult != 1.0:
        scale = scale / scale_mult

    new_cache = None
    if cache is not None:
        _write_cache(cache, ckv, None, active)
        new_cache = KVCache(cache.k, None, cache.pos + S)
        lat = cache.k
        c_nope = lat[..., :R].to(F32)
        c_pe = lat[..., R:].to(F32)
        # absorbed: q_lat[h] = q_nope[h] @ W_uk[h]^T, (B, S, H, kv_lora)
        q_lat = torch.einsum("bshk,hrk->bshr", q_nope.to(F32),
                             p["w_uk"].to(F32))
        scores = (torch.einsum("bshr,btr->bhst", q_lat, c_nope)
                  + torch.einsum("bshk,btk->bhst", q_pe.to(F32), c_pe))
        scores = scores / scale
        kpos = torch.arange(lat.shape[1], device=x.device)
        cpos = (cache.pos[:, None, None, None] if cache.pos.ndim
                else cache.pos)
        scores = torch.where(kpos <= cpos, scores, _NEG)
        probs = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_nope)
        ctx = torch.einsum("bshr,hrv->bshv", ctx_lat,
                           p["w_uv"].to(F32)).to(x.dtype)
    else:
        c32 = ckv[..., :R].to(F32)
        k_nope = torch.einsum("bsr,hrk->bshk", c32, p["w_uk"].to(F32))
        v = torch.einsum("bsr,hrv->bshv", c32, p["w_uv"].to(F32))
        if S * S > _FLASH_THRESHOLD:
            # the nope and rope halves as one q/k: standard attention
            # with Dv != Dqk, which the chunked path takes
            BF = x.dtype
            q_eff = torch.cat([q_nope.to(BF), q_pe.to(BF)], dim=-1)
            k_pe_h = ckv[:, :, None, R:].expand(B, S, H, m.rope_dim)
            k_eff = torch.cat([k_nope.to(BF), k_pe_h.to(BF)], dim=-1)
            ctx = flash_attention(q_eff, k_eff, v.to(BF), causal=True)
        else:
            scores = (torch.einsum("bshk,bthk->bhst", q_nope.to(F32),
                                   k_nope)
                      + torch.einsum("bshk,btk->bhst", q_pe.to(F32),
                                     ckv[..., R:].to(F32)))
            scores = scores / scale
            mask = causal_mask(S, S, device=x.device)[0]
            scores = torch.where(mask, scores, _NEG)
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhst,bthv->bshv", probs, v).to(x.dtype)

    ctx = constrain(ctx, ("batch", "seq", "heads", "d_head"), "attn_ctx")
    ctx = relayout(relayout(ctx, "mergeable", 2, 3), "mergeable", 0, 1)
    out = ctx.reshape(B, S, -1) \
        @ p["w_o"].reshape(-1, D)
    return out, new_cache
