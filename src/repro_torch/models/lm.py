"""Decoder LM assembly: the dense, xLSTM, hybrid Mamba + MoE (jamba) and
MLA + MoE (deepseek-v2/v3, with deepseek-v3's MTP loss) families, with
the tokens, audio-frames (musicgen) and vision (llama-3.2-vision:
cross-attention layers over image embeddings) frontends.

Counterpart of ``repro.models.lm``.  Parameters keep the reference's
paths and layout (``group0/b0/mix/w_q`` of shape ``(layers, D, H, Dh)``
for a stacked group); where the reference runs ``lax.scan`` over the
stacked ``layers`` axis, this module loops over it.

Entry points:

* ``loss_fn(params, batch)`` — training loss and its metrics (the MoE
  aux terms and the MTP loss included); with ``remat`` each layer of a
  stacked group is recomputed in the backward pass, as the reference's
  ``jax.checkpoint`` of the scan body.
* ``logits_fn(params, batch)`` — full-sequence logits (teacher forcing).
* ``prefill(params, batch)`` — full-sequence forward; returns the
  last-position logits (as the reference does; it returns no caches).
* ``decode_step(params, batch, caches)`` — one-token step with KV (MLA:
  latent), SSM or xLSTM state caches, scalar or per-slot positions,
  optional ``active`` gating.
* ``init_caches(B, S_max, vector_pos=)`` — zero caches in the reference's
  pytree layout.

A batch holds ``tokens`` (B, S), or ``frames`` (B, S, d_model) for the
audio-frames frontend, which has no ``embed`` leaf; the vision frontend
adds ``img_embeds`` (B, n_img_tokens, d_model), which every ``xattn``
layer attends to.  Both are cast to bf16, as the reference casts them.

With ``use_kernels=True`` the full-sequence GQA attention runs the flash
attention kernel (MLA runs no kernel, as the reference's takes none),
the full-sequence mLSTM the chunkwise kernel, the full-sequence Mamba
scan the selective-scan kernel, both expert products of every MoE FFN
(prefill and decode) the grouped-matmul kernel, and every RMS norm the RMSNorm kernel.  The reference routes only attention,
the mLSTM and the Mamba scan through its kernels; its RMSNorm and
grouped-matmul kernels compute exactly ``rms_norm`` and the expert
einsums, and are wired in here so that the serving loop, whose attention
is the plain ``_sdpa`` over the cache, runs kernels of its own.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import resolve_device
from ..bridge import params_from_numpy
from ..configs.base import ArchConfig
from .attention import (KVCache, gqa_attention, init_gqa, init_mla,
                        mla_attention)
from .layers import (BF16, F32, ParamBuilder, apply_norm, cross_entropy,
                     init_mlp, init_norm, mlp)
from .moe import MoEAux, init_moe, moe_ffn
from .ssm import SSMState, init_mamba, mamba_block
from .xlstm import (MLSTMState, SLSTMState, init_mlstm, init_slstm,
                    mlstm_block, slstm_block)


AUX_LB_WEIGHT = 0.01
AUX_Z_WEIGHT = 1e-3
MTP_WEIGHT = 0.3
REMATS = ("none", "full", "dots")
#: ``remat="dots"``: keep the outputs of the un-batched matrix products
#: and recompute the rest, as ``dots_with_no_batch_dims_saveable`` does
_DOTS_CONTEXTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _noop_constrain(x, dims, site=None):
    return x


def _like(tup: tuple, items) -> tuple:
    """A tuple of ``tup``'s type (plain or NamedTuple) holding ``items``."""
    items = list(items)
    return type(tup)(*items) if hasattr(tup, "_fields") else tuple(items)


def _map_cache(fn, *caches):
    """Apply ``fn`` leaf-wise over cache or param pytrees: dicts, tuples
    and NamedTuples of tensors (a Mamba cache is the plain tuple
    ``(SSMState(h), conv_carry)``), ``None`` leaves kept."""
    first = caches[0]
    if isinstance(first, dict):
        return {key: _map_cache(fn, *(c[key] for c in caches))
                for key in first}
    if isinstance(first, tuple):
        return _like(first, (None if f is None else _map_cache(fn, f, *rest)
                             for f, *rest in zip(*caches)))
    return fn(*caches)


def _records_grad(resid: torch.Tensor, gparams: dict) -> bool:
    """Whether autograd records a layer that reads ``resid`` and
    ``gparams``: grad mode on and an input that requires grad."""
    if not torch.is_grad_enabled():
        return False
    if resid.requires_grad:
        return True
    found = []
    _map_cache(lambda t: found.append(t.requires_grad), gparams)
    return any(found)


def _stack_layers(old, given, new):
    """The stacked cache of a group from its per-layer caches, as
    ``lax.scan`` stacks them: ``given[i]`` is the view of ``old`` that
    layer ``i`` was handed, ``new[i]`` what it returned.  A leaf that
    every layer returned as the very view it was given was written in
    place (attention k/v, MLA's latent), so the stacked ``old`` leaf holds
    it; every other leaf is stacked anew."""
    if isinstance(old, dict):
        return {key: _stack_layers(old[key], [g[key] for g in given],
                                   [n[key] for n in new]) for key in old}
    if isinstance(old, tuple):
        return _like(old, (_stack_layers(o, [g[j] for g in given],
                                         [n[j] for n in new])
                           for j, o in enumerate(old)))
    if all(n is g for n, g in zip(new, given)):
        return old
    return torch.stack(new)


@dataclass
class LM:
    cfg: ArchConfig
    use_kernels: bool = False
    device: torch.device | str = "cuda"
    #: ``False`` loops the sLSTM recurrence of a full sequence from the
    #: host on CUDA too, where by default it replays from a CUDA graph
    graphs: bool | None = None
    #: ``none``, ``full`` or ``dots``: what each layer of a stacked group
    #: keeps for the backward pass.  It applies only where autograd
    #: records the layer (``_records_grad``); prefill, decode and the CUDA
    #: graphs run with params that require no grad, and never reach it
    remat: str = "full"
    #: the ``ShardingPlan`` of ``repro_torch.core.optimize`` (or ``None``);
    #: its ``constrain`` runs at every constraint site, the identity on
    #: one card
    plan: Any = None

    def __post_init__(self):
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")
        self.device = resolve_device(self.device)

    # -- helpers ---------------------------------------------------------------
    @property
    def constrain(self) -> Callable:
        """The plan's constraint, or the no-op without one, as in the
        reference.  With no device mesh the plan's is the identity too;
        placing tensors on a mesh is ROADMAP A8."""
        if self.plan is None:
            return _noop_constrain
        return self.plan.constrain

    def _groups(self):
        return self.cfg.layer_groups()

    # -- init --------------------------------------------------------------------
    def _build(self, pb: ParamBuilder) -> tuple[dict, dict]:
        cfg = self.cfg
        if cfg.frontend != "audio_frames":
            pb.weight("embed", (cfg.vocab, cfg.d_model),
                      ("vocab", "d_model"), scale=0.02)
        for gi, (pattern, repeats) in enumerate(self._groups()):
            stack = repeats if repeats > 1 else None
            for j, (mix, ffn) in enumerate(pattern):
                pfx = f"group{gi}/b{j}"
                init_norm(pb, f"{pfx}/norm1", cfg.norm, cfg.d_model,
                          stack=stack)
                if mix in ("attn", "xattn"):
                    (init_mla if cfg.mla is not None else init_gqa)(
                        pb, f"{pfx}/mix", cfg, stack=stack)
                elif mix == "mlstm":
                    init_mlstm(pb, f"{pfx}/mix", cfg, stack=stack)
                elif mix == "slstm":
                    init_slstm(pb, f"{pfx}/mix", cfg, stack=stack)
                elif mix == "mamba":
                    init_mamba(pb, f"{pfx}/mix", cfg, stack=stack)
                else:
                    raise NotImplementedError(f"mixer {mix!r}")
                if ffn != "none":
                    init_norm(pb, f"{pfx}/norm2", cfg.norm, cfg.d_model,
                              stack=stack)
                if ffn == "dense":
                    init_mlp(pb, f"{pfx}/ffn", cfg.d_model,
                             cfg.dense_d_ff or cfg.d_ff, stack=stack)
                elif ffn == "moe":
                    init_moe(pb, f"{pfx}/ffn", cfg, stack=stack)
        init_norm(pb, "final_norm", cfg.norm, cfg.d_model)
        if not cfg.tie_embeddings:
            pb.weight("head", (cfg.d_model, cfg.vocab), ("d_model", "vocab"),
                      scale=0.02)
        if cfg.mtp:
            pb.weight("mtp/proj", (2 * cfg.d_model, cfg.d_model),
                      ("d_model2", "d_model"))
            init_norm(pb, "mtp/norm1", cfg.norm, cfg.d_model)
            init_gqa(pb, "mtp/mix", cfg)
            init_norm(pb, "mtp/norm2", cfg.norm, cfg.d_model)
            init_mlp(pb, "mtp/ffn", cfg.d_model, cfg.dense_d_ff or cfg.d_ff)
        return pb.params, pb.dims

    def init(self, seed: int = 0) -> tuple[dict, dict]:
        """Returns (params, dims), drawn on the model's device from a
        ``torch.Generator`` seeded with ``seed``, at the reference's
        stds."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._build(ParamBuilder(gen, device=self.device))

    def param_shapes(self) -> dict:
        """The parameter tree on the meta device: paths, shapes, dtypes."""
        return self._build(ParamBuilder(None, device=torch.device("meta")))[0]

    def load_params(self, tree: dict) -> dict:
        """Reference params (nested dicts of numpy arrays) → this model's
        params on its device; paths, shapes and dtypes must match."""
        return params_from_numpy(tree, self.device, like=self.param_shapes())

    # -- one block ----------------------------------------------------------------
    def _block(self, resid, bp, mix, ffn, positions, img, cache=None,
               active=None):
        """One layer; returns (resid, aux, new_cache) with ``aux`` the
        ``MoEAux`` of an MoE FFN, else ``None``.  An ``xattn`` layer
        attends to ``img``."""
        cfg = self.cfg
        c = self.constrain
        x = apply_norm(cfg.norm, resid, bp["norm1"], self.use_kernels)
        new_cache = None
        aux = None
        if mix in ("attn", "xattn") and cfg.mla is not None:
            out, new_cache = mla_attention(x, bp["mix"], cfg, positions, c,
                                           cache=cache, active=active)
        elif mix in ("attn", "xattn"):
            out, new_cache = gqa_attention(
                x, bp["mix"], cfg, positions, c, cache=cache,
                kv_x=img if mix == "xattn" else None,
                use_kernels=self.use_kernels and cache is None,
                active=active)
        elif mix == "mlstm":
            if cache is not None:
                out, new_cache = mlstm_block(x, bp["mix"], cfg, c,
                                             state=cache)
            else:
                out = mlstm_block(x, bp["mix"], cfg, c,
                                  use_kernels=self.use_kernels)
        elif mix == "slstm":
            if cache is not None:
                out, new_cache = slstm_block(x, bp["mix"], cfg, c,
                                             state=cache)
            else:
                out = slstm_block(x, bp["mix"], cfg, c, graphs=self.graphs)
        elif mix == "mamba":
            if cache is not None:
                state, carry = cache
                out, state, carry = mamba_block(
                    x, bp["mix"], cfg, c, state=state, conv_carry=carry)
                new_cache = (state, carry)
            else:
                out = mamba_block(x, bp["mix"], cfg, c,
                                  use_kernels=self.use_kernels)
        else:
            raise NotImplementedError(f"mixer {mix!r}")
        resid = resid + out
        resid = c(resid, ("batch", "seq", "d_model"), "residual")
        if ffn == "dense":
            x2 = apply_norm(cfg.norm, resid, bp["norm2"], self.use_kernels)
            resid = resid + mlp(x2, bp["ffn"], c)
        elif ffn == "moe":
            x2 = apply_norm(cfg.norm, resid, bp["norm2"], self.use_kernels)
            moe_out, aux = moe_ffn(x2, bp["ffn"], cfg, c,
                                   use_kernels=self.use_kernels)
            resid = resid + moe_out
        resid = c(resid, ("batch", "seq", "d_model"), "residual2")
        return resid, aux, new_cache

    def _super_block(self, resid, gparams, pattern, positions, img,
                     caches=None, active=None):
        """Returns (resid, the MoEAux of each MoE layer, new_caches)."""
        auxes = []
        new_caches = {} if caches is not None else None
        for j, (mix, ffn) in enumerate(pattern):
            cache = caches.get(f"b{j}") if caches is not None else None
            resid, aux, nc = self._block(resid, gparams[f"b{j}"], mix, ffn,
                                         positions, img, cache, active)
            if aux is not None:
                auxes.append(aux)
            if caches is not None:
                new_caches[f"b{j}"] = nc
        return resid, auxes, new_caches

    # -- forward -------------------------------------------------------------------
    def _backbone(self, params, resid, positions, img, caches=None,
                  active=None):
        """Runs all layer groups; returns (resid, the MoEAux of each MoE
        layer in order, new_caches)."""
        auxes = []
        new_caches = {} if caches is not None else None
        for gi, (pattern, repeats) in enumerate(self._groups()):
            gparams = params[f"group{gi}"]
            gcaches = caches.get(f"group{gi}") if caches is not None else None
            if repeats == 1:
                resid, ax, nc = self._super_block(resid, gparams, pattern,
                                                  positions, img, gcaches,
                                                  active)
                auxes += ax
                if caches is not None:
                    new_caches[f"group{gi}"] = nc
                continue
            # the loop that replaces lax.scan over the stacked layers axis
            remat = (self.remat != "none" and caches is None
                     and _records_grad(resid, gparams))
            given, per_layer = [], []
            for i in range(repeats):
                lp = _map_cache(lambda t, i=i: t[i], gparams)
                lc = (_map_cache(lambda t, i=i: t[i], gcaches)
                      if caches is not None else None)
                if remat:
                    resid, ax = self._remat_layer(resid, lp, pattern,
                                                  positions, img)
                    nc = None
                else:
                    resid, ax, nc = self._super_block(
                        resid, lp, pattern, positions, img, lc, active)
                auxes += ax
                given.append(lc)
                per_layer.append(nc)
            if caches is not None:
                new_caches[f"group{gi}"] = _stack_layers(gcaches, given,
                                                         per_layer)
        return resid, auxes, new_caches

    def _remat_layer(self, resid, lp, pattern, positions, img):
        """One layer of a stacked group under ``torch.utils.checkpoint``,
        the counterpart of the reference's ``jax.checkpoint`` of its scan
        body; returns (resid, the MoEAux of each MoE layer)."""
        def layer(r, lp):
            r, ax, _ = self._super_block(r, lp, pattern, positions, img)
            return r, ax
        kw = {"context_fn": _DOTS_CONTEXTS} if self.remat == "dots" else {}
        return checkpoint(layer, resid, lp, use_reentrant=False, **kw)

    def _embed(self, params, batch):
        """(resid, img): the frames or the tokens' embeddings, and the
        image embeddings of the vision frontend (else ``None``), both in
        bf16."""
        cfg = self.cfg
        if cfg.frontend == "audio_frames":
            resid = batch["frames"].to(BF16)
        else:
            resid = params["embed"][batch["tokens"]].to(BF16)
        resid = self.constrain(resid, ("batch", "seq", "d_model"),
                               "embed_out")
        img = (batch["img_embeds"].to(BF16) if cfg.frontend == "vision"
               else None)
        return resid, img

    def _batch_seq(self, batch) -> tuple[int, int]:
        """(B, S) of a batch: from ``frames`` for the audio frontend."""
        if self.cfg.frontend == "audio_frames":
            return tuple(batch["frames"].shape[:2])
        return tuple(batch["tokens"].shape)

    def _head(self, params, resid):
        cfg = self.cfg
        x = apply_norm(cfg.norm, resid, params["final_norm"],
                       self.use_kernels)
        table = (params["embed"].T if cfg.tie_embeddings
                 else params["head"])
        logits = x @ table.to(BF16)
        return self.constrain(logits, ("batch", "seq", "vocab"), "logits")

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device).expand(B, S)

    def logits_fn(self, params, batch) -> torch.Tensor:
        """Full-sequence logits (teacher forcing)."""
        B, S = self._batch_seq(batch)
        resid, img = self._embed(params, batch)
        resid, _, _ = self._backbone(params, resid, self._positions(B, S),
                                     img)
        return self._head(params, resid)

    def loss_fn(self, params, batch) -> tuple[torch.Tensor, dict]:
        """(loss, metrics) of a batch of ``tokens`` and ``labels`` (B, S):
        the mean cross-entropy with its z-loss (``xent``), with the MTP
        head's loss (``mtp``) at ``MTP_WEIGHT`` where the config has one,
        plus the MoE layers' summed load-balance (``aux_lb``) and router z
        losses (``aux_z``) at ``AUX_LB_WEIGHT`` and ``AUX_Z_WEIGHT``; the
        aux terms are zeros without MoE layers, as the reference's are."""
        B, S = batch["labels"].shape
        positions = self._positions(B, S)
        resid, img = self._embed(params, batch)
        resid, auxes, _ = self._backbone(params, resid, positions, img)
        logits = self._head(params, resid)
        loss = cross_entropy(logits, batch["labels"])
        lb = zl = torch.zeros((), device=self.device)
        for a in auxes:
            lb = lb + a.load_balance_loss
            zl = zl + a.router_z_loss
        metrics = {"xent": loss, "aux_lb": lb, "aux_z": zl}
        if self.cfg.mtp:
            mtp_loss = self._mtp_loss(params, resid, batch, positions)
            metrics["mtp"] = mtp_loss
            loss = loss + MTP_WEIGHT * mtp_loss
        loss = loss + AUX_LB_WEIGHT * lb + AUX_Z_WEIGHT * zl
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, params, resid, batch, positions):
        """DeepSeek-V3's depth-1 multi-token prediction: the final hidden
        state, normed, beside the embedding of the next token, projected
        back to ``d_model``; one more block (GQA, then the dense FFN);
        the shared head predicts token t+2 (labels shifted by 2,
        zero-padded; no z-loss)."""
        cfg = self.cfg
        mp = params["mtp"]
        nxt = torch.nn.functional.pad(batch["labels"][:, 1:], (0, 1))
        emb = params["embed"][nxt].to(BF16)
        h = torch.cat([apply_norm(cfg.norm, resid, mp["norm1"],
                                  self.use_kernels), emb], dim=-1)
        h = h @ mp["proj"]
        out, _ = gqa_attention(h, mp["mix"], cfg, positions, self.constrain)
        h = h + out
        x2 = apply_norm(cfg.norm, h, mp["norm2"], self.use_kernels)
        h = h + mlp(x2, mp["ffn"], self.constrain)
        logits = self._head(params, h)
        labels = torch.nn.functional.pad(batch["labels"][:, 2:], (0, 2))
        return cross_entropy(logits, labels, z_loss=0.0)

    def prefill(self, params, batch, with_aux: bool = False):
        """Full-sequence forward returning the last-position logits
        ``(B, 1, vocab)``; with ``with_aux``, ``(logits, aux)`` where
        ``aux`` sums the MoE layers' load-balance and z losses (the
        reference's backbone totals) and averages their dropped
        fractions (``None`` without MoE layers)."""
        B, S = self._batch_seq(batch)
        resid, img = self._embed(params, batch)
        resid, auxes, _ = self._backbone(params, resid,
                                         self._positions(B, S), img)
        logits = self._head(params, resid[:, -1:])
        if not with_aux:
            return logits
        aux = None
        if auxes:
            aux = MoEAux(sum(a.load_balance_loss for a in auxes),
                         sum(a.router_z_loss for a in auxes),
                         sum(a.dropped_fraction for a in auxes) / len(auxes))
        return logits, aux

    def decode_step(self, params, batch, caches) -> tuple[torch.Tensor, dict]:
        """One-token step: ``batch`` holds the current token ``(B,1)`` (or
        frame ``(B,1,d_model)``, and the image embeddings) and the
        position — a scalar (lock-step batch) or a per-slot ``(B,)``
        vector (caches from ``init_caches(vector_pos=True)``).

        ``batch["active"]`` (optional, ``(B,)`` bool, vector positions
        only) gates the cache write-back per slot: an inactive slot's
        caches come out bit-identical to never stepping.  The k/v caches
        are updated in place, so the ``caches`` passed in are the ones
        returned, with new position tensors."""
        B = self._batch_seq(batch)[0]
        pos = batch["pos"]
        positions = pos[:, None] if pos.ndim else pos.expand(B, 1)
        active = batch.get("active")
        resid, img = self._embed(params, batch)
        resid, _, new_caches = self._backbone(params, resid, positions, img,
                                              caches=caches, active=active)
        if active is not None:
            new_caches = self._gate_caches(active, caches, new_caches)
        logits = self._head(params, resid)
        return logits, new_caches

    def _gate_caches(self, active, old, new):
        """Per-slot select between the stepped and the previous cache
        leaves.  The batch axis is 0, or 1 inside a stacked group whose
        leading axis is ``layers``.  Leaves written in place were gated at
        the write (``attention._write_cache``) and pass through."""
        out: dict = {}
        for gi, (_pattern, repeats) in enumerate(self._groups()):
            ax = 1 if repeats > 1 else 0
            B = active.shape[0]

            def sel(o, n, ax=ax):
                if n is o:
                    return n
                shape = [1] * n.ndim
                shape[ax] = B
                return torch.where(active.reshape(shape), n, o)

            g = f"group{gi}"
            out[g] = _map_cache(sel, old[g], new[g])
        return out

    # -- serving -------------------------------------------------------------------
    def init_caches(self, B: int, S_max: int,
                    vector_pos: bool = False) -> dict:
        """Zero caches ``{"group0": {"b0": cache}}``, each leaf with a
        leading ``layers`` axis inside a stacked group: ``KVCache(k, v,
        pos)`` with ``k``/``v`` of shape ``(B, S_max, KVH, Dh)`` for
        attention, ``(SSMState(h), conv_carry)`` with ``h`` ``(B, Din, N)``
        f32 and the carry ``(B, d_conv-1, Din)`` bf16 for Mamba,
        ``KVCache(lat, None, pos)`` with the latent ``lat`` of shape
        ``(B, S_max, kv_lora + rope_dim)`` for MLA, and
        ``MLSTMState(C, n, m)`` and ``SLSTMState(c, n, h, m)`` in f32 for
        the xLSTM mixers (``m`` starts at 0, as the reference's caches
        do).

        ``vector_pos=True`` makes every position a per-slot ``(B,)``
        vector, as the continuous-batching server needs."""
        caches: dict = {}
        for gi, (pattern, repeats) in enumerate(self._groups()):
            caches[f"group{gi}"] = {
                f"b{j}": self._block_cache(mix, B, S_max, repeats,
                                           vector_pos)
                for j, (mix, _ffn) in enumerate(pattern)}
        return caches

    def _block_cache(self, mix, B, S_max, repeats, vector_pos):
        cfg = self.cfg
        lead = (repeats,) if repeats > 1 else ()

        def z(shape, dtype=BF16):
            return torch.zeros(lead + shape, dtype=dtype, device=self.device)

        pos = z((B,) if vector_pos else (), torch.int32)
        if mix in ("attn", "xattn") and cfg.mla is not None:
            m = cfg.mla
            return KVCache(z((B, S_max, m.kv_lora + m.rope_dim)), None, pos)
        if mix in ("attn", "xattn"):
            KVH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
            return KVCache(z((B, S_max, KVH, Dh)), z((B, S_max, KVH, Dh)),
                           pos)
        if mix == "mlstm":
            H = cfg.n_heads
            Dh = cfg.xlstm.proj_factor_mlstm * cfg.d_model // H
            return MLSTMState(z((B, H, Dh, Dh), F32), z((B, H, Dh), F32),
                              z((B, H), F32))
        if mix == "slstm":
            D = cfg.d_model
            return SLSTMState(*(z((B, D), F32) for _ in range(4)))
        if mix == "mamba":
            mb = cfg.mamba
            Din = mb.expand * cfg.d_model
            return (SSMState(z((B, Din, mb.d_state), F32)),
                    z((B, mb.d_conv - 1, Din)))
        raise NotImplementedError(f"mixer {mix!r}")
