"""The audio-frames (musicgen) and vision (llama-3.2-vision) frontends of
the port against the reference, on both smoke configs with the
reference's params bridged in: cross-attention (``gqa_attention`` with
``kv_x``), ``logits_fn``, ``prefill`` and decode, the loss and its
gradients through ``build_train_step``, and greedy serving with the
reference's own frames and images handed in through the ``Draws`` seam.

In decode the reference's cross-attention writes its context into the
layer's KV cache as self-attention writes k/v: per-slot positions write
image row 0 at each slot's position, a scalar position every image row
from ``min(pos, S_c - n_img)``, and the step attends to the rows
``<= pos``.  So a vision model's decode attends to image row 0 (until the
clamp moves the rows), where ``logits_fn`` attends to all of them.  The
port copies this; the tests pin it in both packages.

Tolerances are ``test_kernels.py``'s and ``test_models.py``'s: logits at
the bf16 2e-2, decode against the teacher-forced logits at atol 0.25,
rtol 0.1; loss and gradients as ``test_torch_train.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.models import attention as JA
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import graphs
from repro_torch.launch import scheduler as TS
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.steps import build_train_step
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LM
from torch_parity import (RefDraws, both, f32, flat, numpy_tree,
                          strict_jit, tol)

ARCHS = ["musicgen-large", "llama-3.2-vision-11b"]
B, S = 2, 16
#: the serving tests' cache: holds the smoke image (8 rows) past every
#: position they reach, so the scalar write never clamps there
S_MAX = 64
LOSS_TOL = dict(atol=5e-3, rtol=1e-3)
GRAD_REL = 2e-2


def _noop(t, dims, site=None):
    return t


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jlm = JLM(jget(arch, smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config(arch, smoke=True), device="cpu")
    return jlm, jparams, lm, lm.load_params(numpy_tree(jparams))


def _inputs(cfg, b=B, s=S, seed=0) -> dict:
    """A numpy batch as ``tests/test_models.py`` builds one: labels, then
    tokens or frames, and the image of the vision frontend."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.frontend == "audio_frames":
        out["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s))
    if cfg.frontend == "vision":
        out["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jb(batch: dict, *drop) -> dict:
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
            for k, v in batch.items() if k not in drop}


def _tb(batch: dict, *drop) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()
            if k not in drop}


def _step_inputs(batch: dict, t: int, img=None) -> dict:
    """Decode step ``t``'s slice of a numpy batch."""
    out = {k: batch[k][:, t:t + 1] for k in ("tokens", "frames")
           if k in batch}
    if "img_embeds" in batch:
        out["img_embeds"] = batch["img_embeds"] if img is None else img
    return out


def test_frontend_models_build_and_cross_by_path(pair):
    """Both models build; musicgen has no ``embed`` leaf, llama-vision's
    cross-attention layers are the 5th of each group, and every leaf
    crosses by path with no special case."""
    jlm, jparams, lm, params = pair
    jf, tf = flat(numpy_tree(jparams)), flat(params)
    assert sorted(jf) == sorted(tf)
    for path, a in jf.items():
        assert tuple(tf[path].shape) == a.shape, path
        assert np.array_equal(f32(tf[path]), f32(a)), path
    assert ("embed" in tf) == (lm.cfg.frontend != "audio_frames")
    kinds = [m for m, _ in lm.cfg.layer_kinds()]
    assert ("xattn" in kinds) == (lm.cfg.frontend == "vision")


# -- gqa_attention with kv_x ---------------------------------------------------

def _attn_params(cfg, rng):
    D, H, KVH, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    pj, pt = {}, {}
    for name, shape in {"w_q": (D, H, Dh), "w_kv": (D, 2, KVH, Dh),
                        "w_o": (H, Dh, D)}.items():
        pj[name], pt[name] = both(rng.normal(size=shape) / np.sqrt(
            shape[0]), "bfloat16")
    return pj, pt


def _jxattn(x, p, cfg, positions, kv_x, cache=None, use_kernels=False):
    return jax.jit(lambda x, p, pos, kv, c: JA.gqa_attention(
        x, p, cfg, pos, _noop, cache=c, kv_x=kv,
        use_kernels=use_kernels))(x, p, positions, kv_x, cache)


@pytest.mark.parametrize("path,Sq,Skv", [
    ("sdpa", 24, 40),
    # Sq·Sq is under the chunked path's threshold and Sq·Skv over it: the
    # reference chooses by Sq·Skv, so both take the chunked path
    ("chunked", 1024, 3072),
    ("kernel", 24, 40),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_full_sequence(arch, path, Sq, Skv, monkeypatch):
    """Cross-attention over a context stream: k/v from ``kv_x``, no RoPE,
    no causal mask; each plain branch and the kernel wrapper's CPU path
    (the reference's Pallas kernel in interpret mode)."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(4)
    pj, pt = _attn_params(cfg, rng)
    xj, xt = both(rng.normal(size=(1, Sq, cfg.d_model)), "bfloat16")
    kj, kt = both(rng.normal(size=(1, Skv, cfg.d_model)), "bfloat16")
    posj = jnp.broadcast_to(jnp.arange(Sq), (1, Sq))
    chunked = []
    orig = TA.flash_attention
    monkeypatch.setattr(TA, "flash_attention", lambda *a, **k: (
        chunked.append(k["causal"]), orig(*a, **k))[1])
    kernel = path == "kernel"
    want, _ = _jxattn(xj, pj, jcfg, posj, kj, use_kernels=kernel)
    got, cache = TA.gqa_attention(xt, pt, cfg, torch.arange(Sq)[None],
                                  _noop, kv_x=kt, use_kernels=kernel)
    assert cache is None and tuple(got.shape) == (1, Sq, cfg.d_model)
    assert chunked == ([False] if path == "chunked" else [])
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def _cache_pair(cfg, b, s_max, pos, rng):
    KVH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kj, kt = both(rng.normal(size=(b, s_max, KVH, Dh)), "bfloat16")
    vj, vt = both(rng.normal(size=(b, s_max, KVH, Dh)), "bfloat16")
    pos = np.asarray(pos, np.int32)
    return (JA.KVCache(kj, vj, jnp.asarray(pos)),
            TA.KVCache(kt, vt, torch.as_tensor(pos)))


def _ctx_kv(pt, cfg, kv_x):
    """The k/v rows the port's projection gives the context ``kv_x``."""
    KVH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kv = (kv_x @ pt["w_kv"].reshape(cfg.d_model, -1)).reshape(
        kv_x.shape[0], kv_x.shape[1], 2, KVH, Dh)
    return kv[:, :, 0], kv[:, :, 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_decode_per_slot(arch):
    """Per-slot decode writes context row 0 at each slot's position (the
    reference's scatter of ``k[:, 0]``); an inactive slot's cache stays
    bit-identical."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(5)
    pj, pt = _attn_params(cfg, rng)
    n_img, s_max = 8, 20
    pos = np.array([0, 7, 19], np.int32)
    cj, ct = _cache_pair(cfg, 3, s_max, pos, rng)
    xj, xt = both(rng.normal(size=(3, 1, cfg.d_model)), "bfloat16")
    ij, it = both(rng.normal(size=(3, n_img, cfg.d_model)), "bfloat16")
    want, nj = _jxattn(xj, pj, jcfg, jnp.asarray(pos[:, None]), ij, cj)
    old_k = ct.k.clone()
    active = torch.tensor([True, False, True])
    got, nt = TA.gqa_attention(xt, pt, cfg, torch.as_tensor(pos[:, None]),
                               _noop, cache=ct, kv_x=it, active=active)
    np.testing.assert_allclose(f32(got[active]), f32(want)[active.numpy()],
                               **tol("bfloat16"))
    assert np.array_equal(nt.pos.numpy(), np.asarray(nj.pos))
    assert nt.pos.tolist() == (pos + 1).tolist()
    k0, _ = _ctx_kv(pt, cfg, it)
    for r in range(3):
        if active[r]:
            np.testing.assert_allclose(f32(nt.k[r]), f32(nj.k[r]),
                                       **tol("bfloat16"))
            assert torch.equal(nt.k[r, pos[r]], k0[r, 0])
        else:
            assert torch.equal(nt.k[r], old_k[r])


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_decode_scalar(arch):
    """A scalar position writes every context row from ``pos``, clamped
    to ``S_c - n_img`` as ``dynamic_update_slice`` clamps it; a context
    longer than the cache raises in the port, as the reference refuses
    to trace it."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(6)
    pj, pt = _attn_params(cfg, rng)
    n_img, s_max = 8, 20
    ij, it = both(rng.normal(size=(2, n_img, cfg.d_model)), "bfloat16")
    k_ctx, _ = _ctx_kv(pt, cfg, it)
    for pos, start in ((3, 3), (16, s_max - n_img)):
        cj, ct = _cache_pair(cfg, 2, s_max, pos, rng)
        xj, xt = both(rng.normal(size=(2, 1, cfg.d_model)), "bfloat16")
        positions = np.full((2, 1), pos)
        want, nj = _jxattn(xj, pj, jcfg, jnp.asarray(positions), ij, cj)
        got, nt = TA.gqa_attention(xt, pt, cfg, torch.as_tensor(positions),
                                   _noop, cache=ct, kv_x=it)
        np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
        np.testing.assert_allclose(f32(nt.k), f32(nj.k), **tol("bfloat16"))
        np.testing.assert_allclose(f32(nt.v), f32(nj.v), **tol("bfloat16"))
        assert int(nt.pos) == int(nj.pos) == pos + 1
        assert torch.equal(nt.k[:, start:start + n_img], k_ctx)
    cj, ct = _cache_pair(cfg, 2, n_img - 1, 0, rng)
    positions = np.zeros((2, 1), np.int64)
    xj, xt = both(rng.normal(size=(2, 1, cfg.d_model)), "bfloat16")
    with pytest.raises(ValueError, match="cache"):
        TA.gqa_attention(xt, pt, cfg, torch.as_tensor(positions), _noop,
                         cache=ct, kv_x=it)
    with pytest.raises(TypeError):
        _jxattn(xj, pj, jcfg, jnp.asarray(positions), ij, cj)


# -- the LM --------------------------------------------------------------------

def test_logits_fn(pair):
    jlm, jparams, lm, params = pair
    batch = _inputs(lm.cfg)
    want = jax.jit(jlm.logits_fn)(jparams, _jb(batch, "labels"))
    got = lm.logits_fn(params, _tb(batch, "labels"))
    assert tuple(got.shape) == (B, S, lm.cfg.vocab)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill(pair, use_kernels):
    """The last position's logits, the plain path and the kernels' (the
    reference's Pallas kernels in interpret mode; llama-vision's cross
    layer runs flash attention non-causally over the image)."""
    jlm, jparams, lm, params = pair
    batch = _inputs(lm.cfg, seed=1)
    jk = JLM(jlm.cfg, remat="none", use_kernels=use_kernels)
    want = jax.jit(jk.prefill)(jparams, _jb(batch, "labels"))
    tk = LM(lm.cfg, use_kernels=use_kernels, device="cpu")
    got = tk.prefill(params, _tb(batch, "labels"))
    assert tuple(got.shape) == (B, 1, lm.cfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    assert torch.equal(got, tk.logits_fn(params,
                                         _tb(batch, "labels"))[:, -1:])


def test_decode_steps(pair):
    """12 lock-step decode steps at a scalar position against the
    reference's, logits and caches; at a cache of 16 positions the vision
    layer's write of its 8 image rows clamps from step 9 on."""
    jlm, jparams, lm, params = pair
    batch = _inputs(lm.cfg, seed=2)
    s_max = 16
    jc, tc = jlm.init_caches(B, s_max), lm.init_caches(B, s_max)
    step = jax.jit(jlm.decode_step)
    for t in range(12):
        sb = _step_inputs(batch, t)
        lj, jc = step(jparams, {**_jb(sb), "pos": jnp.asarray(t, jnp.int32)},
                      jc)
        lt, tc = lm.decode_step(params, {
            **_tb(sb), "pos": torch.tensor(t, dtype=torch.int32)}, tc)
        np.testing.assert_allclose(f32(lt), f32(lj), **tol("bfloat16"),
                                   err_msg=f"step {t}")
    for b, jcache in jc["group0"].items():
        np.testing.assert_allclose(f32(tc["group0"][b].k), f32(jcache.k),
                                   **tol("bfloat16"), err_msg=b)
        assert np.array_equal(tc["group0"][b].pos.numpy(),
                              np.asarray(jcache.pos))


def _stepped(decode, init, batch, s_max, img=None):
    """Logits of every position through ``decode``, lock-step from zero
    caches of ``s_max`` positions."""
    caches, outs = init(B, s_max), []
    for t in range(batch["labels"].shape[1]):
        logits, caches = decode(t, _step_inputs(batch, t, img), caches)
        outs.append(f32(logits[:, 0]))
    return np.stack(outs, axis=1)


def test_decode_matches_parallel(pair):
    """The reference's ``test_decode_matches_parallel`` in both packages.
    musicgen's decode reproduces its teacher-forced logits.  The vision
    model's decode does not (see the module docstring): without a
    clamp it equals the teacher-forced logits of an image whose every row
    is row 0, in both packages, and both part from the real image's
    logits from the first step on, by the same amount."""
    jlm, jparams, lm, params = pair
    batch = _inputs(lm.cfg, s=12, seed=3)
    step = jax.jit(jlm.decode_step)

    def jdecode(t, sb, c):
        return step(jparams, {**_jb(sb), "pos": jnp.asarray(t, jnp.int32)},
                    c)

    def tdecode(t, sb, c):
        return lm.decode_step(params, {
            **_tb(sb), "pos": torch.tensor(t, dtype=torch.int32)}, c)

    vision = lm.cfg.frontend == "vision"
    s_max = 12 + (lm.cfg.n_img_tokens if vision else 0)
    jstep = _stepped(jdecode, jlm.init_caches, batch, s_max)
    tstep = _stepped(tdecode, lm.init_caches, batch, s_max)
    np.testing.assert_allclose(tstep, jstep, **tol("bfloat16"))
    jfull = f32(jax.jit(jlm.logits_fn)(jparams, _jb(batch, "labels")))
    tfull = f32(lm.logits_fn(params, _tb(batch, "labels")))
    if not vision:
        for stepped, full in ((jstep, jfull), (tstep, tfull)):
            np.testing.assert_allclose(stepped, full, atol=0.25, rtol=0.1)
            assert np.mean(stepped.argmax(-1) == full.argmax(-1)) > 0.9
        return
    row0 = np.repeat(batch["img_embeds"][:, :1], lm.cfg.n_img_tokens, 1)
    b0 = {**batch, "img_embeds": row0}
    jrow0 = f32(jax.jit(jlm.logits_fn)(jparams, _jb(b0, "labels")))
    trow0 = f32(lm.logits_fn(params, _tb(b0, "labels")))
    gaps = []
    for stepped, full, row0 in ((jstep, jfull, jrow0),
                                (tstep, tfull, trow0)):
        np.testing.assert_allclose(stepped, row0, **tol("bfloat16"))
        gaps.append(np.abs(stepped - full).max(axis=(0, 2)))
    # both part from the real image's logits from the first step on, by
    # the same amount (0.25-0.33 here, on logits up to 0.64)
    assert (gaps[0] > 0.1).all() and (gaps[1] > 0.1).all()
    np.testing.assert_allclose(gaps[1], gaps[0], **tol("bfloat16"))


# -- the train step ------------------------------------------------------------

def test_loss_and_grads_match_reference(pair):
    """``build_train_step``'s loss, metrics and gradients against the
    reference's, jitted strictly (``torch_parity.strict_jit``), as
    ``test_torch_train.py`` holds the other families: loss within atol
    5e-3, rtol 1e-3, each gradient leaf within 2e-2 of its largest
    reference magnitude (+1e-6)."""
    jlm, jparams, lm, params = pair
    batch = _inputs(lm.cfg, seed=4)
    (_, jmetrics), jgrads = strict_jit(
        jax.value_and_grad(jlm.loss_fn, has_aux=True), jparams, _jb(batch))
    step = build_train_step(lm.cfg, remat="none", device="cpu")
    grads, metrics = step.grads(params, batch)
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(f32(metrics[k]), f32(v), **LOSS_TOL,
                                   err_msg=k)
    jg, tg = flat(numpy_tree(jgrads)), flat(grads)
    assert sorted(jg) == sorted(tg)
    for path, want in jg.items():
        w = f32(want)
        np.testing.assert_allclose(f32(tg[path]), w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max() + 1e-6,
                                   err_msg=path)


def test_remat_modes_bit_equal(pair):
    """``remat`` none, full and dots give the same loss and gradients, bit
    for bit, with the image or frames closed over by the recomputed
    layers (musicgen's 2 smoke layers form one stacked group; the vision
    smoke model's 5 layers run at 10, two periods of its pattern)."""
    cfg = pair[2].cfg
    if cfg.frontend == "vision":
        cfg = dataclasses.replace(cfg, n_layers=10)
    assert [r for _, r in cfg.layer_groups()] == [2]
    params, _ = LM(cfg, device="cpu").init(0)
    batch = _inputs(cfg, seed=5)
    out = {}
    for remat in tlm.REMATS:
        grads, metrics = build_train_step(cfg, remat=remat,
                                          device="cpu").grads(params, batch)
        out[remat] = (metrics, flat(grads))
    m0, g0 = out["none"]
    for remat in ("full", "dots"):
        m, g = out[remat]
        for k in m0:
            assert torch.equal(m[k], m0[k]), (remat, k)
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)


def test_grad_accumulation_matches_full_batch(pair):
    """``accum_steps=2`` gives the full batch's update within rtol 2e-2,
    atol 2e-3 (``tests/test_substrate.py``'s), frames and images split
    along the batch axis with the tokens."""
    cfg = pair[2].cfg
    batch = _inputs(cfg, b=4, seed=6)
    outs = []
    for accum in (1, 2):
        step = build_train_step(cfg, remat="full", accum_steps=accum,
                                device="cpu")
        params, _ = step.lm.init(0)
        p1, _, metrics = step.fn(params, step.opt.init(params), batch)
        assert np.isfinite(float(metrics["loss"]))
        outs.append(flat(p1))
    for path, a in outs[0].items():
        np.testing.assert_allclose(f32(a), f32(outs[1][path]), rtol=2e-2,
                                   atol=2e-3, err_msg=path)


# -- serving -------------------------------------------------------------------

def _requests(cfg, n, seed, same_len=False):
    """(prompt or None, prompt_len, max_new) of ``n`` greedy requests."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pl = 6 if same_len else int(rng.integers(3, 9))
        prompt = (None if cfg.frontend == "audio_frames"
                  else rng.integers(0, cfg.vocab, pl))
        out.append((prompt, pl, int(rng.integers(4, 8))))
    return out


def _jreference(pair, reqs, seed=0):
    """The reference's ``decode_offline`` of each request, op by op."""
    jlm, jparams = pair[:2]
    with jax.disable_jit():
        return [JS.decode_offline(jlm, jparams, JS.Request(
            rid=i, prompt_len=pl, max_new=g,
            prompt=None if p is None else p.astype(np.int32)),
            seed=seed, s_max=S_MAX) for i, (p, pl, g) in enumerate(reqs)]


@pytest.mark.parametrize("graphs_on", [None, False], ids=["graphs", "eager"])
def test_batcher_greedy_tokens_match_reference(pair, graphs_on):
    """The batcher's streamed greedy tokens (three requests through two
    slots, so a slot is reused; on the ``StepGraph`` form and eager)
    equal the reference's ``decode_offline``, op by op, with the
    reference's frames and images passed through the ``Draws`` seam."""
    lm, params = pair[2:]
    reqs = _requests(lm.cfg, 3, seed=7)
    b = TS.ContinuousBatcher(lm, params, slots=2, s_max=S_MAX,
                             graphs=graphs_on, draws=RefDraws(0, lm.cfg))
    for p, pl, g in reqs:
        b.submit(p, g, prompt_len=pl)
    rep = b.run()
    got = {r.rid: r.out for r in rep.requests}
    assert [got[i] for i in range(3)] == _jreference(pair, reqs)


def test_run_static_greedy_tokens_match_reference(pair):
    """``run_static`` in one wave of equal prompt lengths (a shorter
    prompt would be padded, and its first token read at the wave's
    longest): every request's greedy tokens equal the reference's
    ``decode_offline``, op by op, on the ``StepGraph`` form and eager."""
    lm, params = pair[2:]
    reqs = _requests(lm.cfg, 2, seed=8, same_len=True)
    want = _jreference(pair, reqs)
    for graphs_on in (None, False):
        rep = TS.run_static(lm, params, [
            TS.Request(rid=i, prompt_len=pl, max_new=g, prompt=p)
            for i, (p, pl, g) in enumerate(reqs)], seed=0, s_max=S_MAX,
            graphs=graphs_on, draws=RefDraws(0, lm.cfg))
        assert [r.out for r in rep.requests] == want, graphs_on


def test_streamed_tokens_match_offline_with_own_draws(pair):
    """With the port's own ``Draws`` (the default), sampled and greedy
    streamed tokens equal the port's ``decode_offline``, as the
    reference's ``test_streamed_tokens_match_offline_all_frontends``."""
    lm, params = pair[2:]
    b = TS.ContinuousBatcher(lm, params, slots=2, s_max=S_MAX, seed=3)
    for i, (p, pl, g) in enumerate(_requests(lm.cfg, 4, seed=9)):
        b.submit(p, g, prompt_len=pl, temperature=0.6 if i % 2 else 0.0)
    for r in b.run().requests:
        assert r.out == TS.decode_offline(lm, params, r, seed=3,
                                          s_max=S_MAX), f"rid {r.rid}"


def test_step_graph_holds_the_frontend_inputs(pair):
    """A ``StepGraph`` of a frontend model owns static ``frames`` or
    ``img_embeds`` beside ``pos`` and ``active``; its run gives the eager
    step's logits and caches."""
    lm, params = pair[2:]
    cfg = lm.cfg
    graphs.release()
    g = graphs.step_graph(lm, params, 2, 16, True, use="test")
    g.reset()
    audio = cfg.frontend == "audio_frames"
    assert (g.tokens is None) == audio and (g.frames is not None) == audio
    assert (g.img_embeds is not None) == (cfg.frontend == "vision")
    batch = _tb(_inputs(cfg, s=1, seed=10), "labels")
    pos = torch.tensor([0, 0], dtype=torch.int32)
    active = torch.tensor([True, False])
    got = g.run(pos=pos, active=active, **batch).clone()
    want, caches = lm.decode_step(params, {**batch, "pos": pos,
                                           "active": active},
                                  lm.init_caches(2, 16, vector_pos=True))
    assert torch.equal(got, want)
    same = []
    tlm._map_cache(lambda a, b: same.append(torch.equal(a, b)), g.caches,
                   caches)
    assert same and all(same)
    graphs.release()


def test_draws_are_keyed_by_seed_request_and_position():
    cfg = get_config("llama-3.2-vision-11b", smoke=True)
    d = TS.Draws(0, cfg)
    f = d.frames_at(1, 2)
    assert f.shape == (1, cfg.d_model) and f.dtype == torch.bfloat16
    assert torch.equal(f, TS.Draws(0, cfg).frames_at(1, 2))
    for other in (TS.Draws(1, cfg).frames_at(1, 2), d.frames_at(2, 2),
                  d.frames_at(1, 3)):
        assert not torch.equal(f, other)
    img = d.image_of(1)
    assert img.shape == (cfg.n_img_tokens, cfg.d_model)
    assert not torch.equal(img, d.image_of(2))


def test_submit_takes_no_prompt_only_for_audio_frames():
    for arch, ok in (("musicgen-large", True),
                     ("llama-3.2-vision-11b", False)):
        lm = LM(get_config(arch, smoke=True), device="cpu")
        params, _ = lm.init(0)
        b = TS.ContinuousBatcher(lm, params, slots=1, s_max=16,
                                 graphs=False)
        if ok:
            r = b.submit(None, 3, prompt_len=5)
            assert r.prompt is None and r.prompt_len == 5
            with pytest.raises(ValueError, match="empty"):
                b.submit(None, 3)
        else:
            with pytest.raises(ValueError, match="prompt"):
                b.submit(None, 3, prompt_len=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_on_cpu(arch):
    """The serve driver on the CPU: every request served, on the batcher
    and on the static path."""
    m = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--slots", "2", "--requests", "3",
                    "--prompt-len-range", "3", "8", "--gen-range", "3", "5",
                    "--static"])
    assert m["continuous"]["requests"] == m["static"]["requests"] == 3
    assert m["continuous"]["generated"] == m["static"]["generated"] > 0
    graphs.release()
