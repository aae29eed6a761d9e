"""``repro_torch.models.xlstm`` and the xLSTM ``LM`` against the reference.

Blocks take the reference's params bridged in and the same numpy inputs;
the ``LM`` tests run the xlstm smoke config (mLSTM, sLSTM, mLSTM, mLSTM),
and its ``n_layers=8`` variant, whose layers form one stacked group
``(m, s, m, m) × 2``.  The reference's chunkwise Pallas kernel runs in
interpret mode, as ``test_kernels.py`` runs it.

Logits and states are compared at the bf16 tolerance with the reference
run op by op (``jax.disable_jit``).  The jitted reference rounds bf16
activations at other places (XLA fuses elementwise chains): on these
inputs its logits differ from its own op-by-op logits by 0.018 at four
layers and 0.033 at eight, so it cannot hold the port to 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import xlstm as jx
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import xlstm as tx
from repro_torch.models.lm import LM
from torch_parity import both, f32, numpy_tree, tol

B, S = 2, 32          # S a multiple of the smoke chunk (16)


def _noop(x, dims, site=None):
    return x


def _cfg(n_layers=None, smoke=True):
    cfg = get_config("xlstm-125m", smoke=smoke)
    jcfg = jget("xlstm-125m", smoke=smoke)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return cfg, jcfg


@pytest.fixture(scope="module", params=[None, 8], ids=["4L", "8L"])
def pair(request):
    cfg, jcfg = _cfg(request.param)
    jlm = JLM(jcfg, remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return jlm, jparams, lm, params, toks


@pytest.fixture(scope="module")
def blocks():
    """The smoke config's mLSTM (group0) and sLSTM (group1) mixer params,
    as reference and port trees."""
    cfg, jcfg = _cfg()
    jparams, _ = JLM(jcfg, remat="none").init(jax.random.PRNGKey(1))
    out = {}
    for kind, g in (("mlstm", "group0"), ("slstm", "group1")):
        jp = jparams[g]["b0"]["mix"]
        out[kind] = (jp, params_from_numpy(numpy_tree(jp), "cpu"))
    return cfg, jcfg, out


def _x(cfg, seq, seed=0):
    return both(np.random.default_rng(seed).normal(
        size=(B, seq, cfg.d_model)), "bfloat16")


# -- blocks ------------------------------------------------------------------


def test_layer_kinds_and_groups():
    cfg, _ = _cfg()
    assert [m for m, _ in cfg.layer_kinds()] == ["mlstm", "slstm", "mlstm",
                                                 "mlstm"]
    assert all(f == "none" for _, f in cfg.layer_kinds())
    cfg8, _ = _cfg(8)
    assert cfg8.layer_groups() == [(tuple(cfg.layer_kinds()), 2)]


def test_mlstm_parallel_matches_reference():
    rng = np.random.default_rng(3)
    shape = (2, 24, 3, 16)
    ins = [rng.normal(size=shape) for _ in range(3)] + [
        rng.normal(size=shape[:3]), rng.normal(size=shape[:3]) + 2.0]
    j, t = zip(*(both(a, "float32") for a in ins))
    np.testing.assert_allclose(f32(tx._mlstm_parallel(*t)),
                               f32(jx._mlstm_parallel(*j)),
                               **tol("float32"))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_mlstm_block_full(blocks, use_kernels):
    cfg, jcfg, p = blocks
    jp, tp = p["mlstm"]
    xj, xt = _x(cfg, S)
    want = jx.mlstm_block(xj, jp, jcfg, _noop, use_kernels=use_kernels)
    got = tx.mlstm_block(xt, tp, cfg, _noop, use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def _state_pair(cls_j, cls_t, shapes, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s) for s in shapes]
    j, t = zip(*(both(a, "float32") for a in arrs))
    return cls_j(*j), cls_t(*t)


def test_mlstm_block_step(blocks):
    cfg, jcfg, p = blocks
    jp, tp = p["mlstm"]
    H = cfg.n_heads
    Dh = cfg.xlstm.proj_factor_mlstm * cfg.d_model // H
    sj, st = _state_pair(jx.MLSTMState, tx.MLSTMState,
                         [(B, H, Dh, Dh), (B, H, Dh), (B, H)], 4)
    xj, xt = _x(cfg, 1, seed=5)
    want, wstate = jx.mlstm_block(xj, jp, jcfg, _noop, state=sj)
    got, gstate = tx.mlstm_block(xt, tp, cfg, _noop, state=st)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    for name in tx.MLSTMState._fields:
        np.testing.assert_allclose(f32(getattr(gstate, name)),
                                   f32(getattr(wstate, name)),
                                   **tol("float32"), err_msg=name)


def test_slstm_block_full(blocks):
    cfg, jcfg, p = blocks
    jp, tp = p["slstm"]
    xj, xt = _x(cfg, S, seed=6)
    want = jx.slstm_block(xj, jp, jcfg, _noop)
    got = tx.slstm_block(xt, tp, cfg, _noop)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def test_slstm_block_step(blocks):
    cfg, jcfg, p = blocks
    jp, tp = p["slstm"]
    D = cfg.d_model
    sj, st = _state_pair(jx.SLSTMState, tx.SLSTMState, [(B, D)] * 4, 7)
    xj, xt = _x(cfg, 3, seed=8)
    want, wstate = jx.slstm_block(xj, jp, jcfg, _noop, state=sj)
    got, gstate = tx.slstm_block(xt, tp, cfg, _noop, state=st)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    for name in tx.SLSTMState._fields:
        np.testing.assert_allclose(f32(getattr(gstate, name)),
                                   f32(getattr(wstate, name)),
                                   **tol("float32"), err_msg=name)


# -- the LM --------------------------------------------------------------------


def test_param_tree_matches_reference(pair):
    jlm, jparams, lm, params, _ = pair
    # load_params checked every path, shape and dtype; no norm2 or ffn
    # where the layer has no FFN
    g0 = params["group0"]["b0"]
    assert set(g0) == {"norm1", "mix"}
    assert set(jparams["group0"]["b0"]) == set(g0)


def test_logits_fn(pair):
    jlm, jparams, lm, params, toks = pair
    with jax.disable_jit():
        want = jlm.logits_fn(jparams, {"tokens": jnp.asarray(toks)})
    got = lm.logits_fn(params, {"tokens": torch.as_tensor(toks)})
    assert tuple(got.shape) == (B, S, lm.cfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill(pair, use_kernels):
    jlm, jparams, lm, params, toks = pair
    jk = JLM(jlm.cfg, remat="none", use_kernels=use_kernels)
    with jax.disable_jit():
        want = jk.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tk = LM(lm.cfg, use_kernels=use_kernels, device="cpu")
    got = tk.prefill(params, {"tokens": torch.as_tensor(toks)})
    assert tuple(got.shape) == (B, 1, lm.cfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for name, v in zip(tree._fields, tree):
            yield f"{prefix}{name}", v
    else:
        yield prefix, tree


def test_lock_step_decode_states(pair):
    """Decode steps with scalar positions: logits, and every mLSTM C/n/m
    and sLSTM c/n/h/m leaf."""
    jlm, jparams, lm, params, toks = pair
    jc = jlm.init_caches(B, S)
    tc = lm.init_caches(B, S)
    jnames = dict(_leaves(jc))
    assert {k: tuple(v.shape) for k, v in _leaves(tc)} == \
        {k: tuple(v.shape) for k, v in jnames.items()}
    with jax.disable_jit():
        for t in range(6):
            lj, jc = jlm.decode_step(jparams, {
                "tokens": jnp.asarray(toks[:, t:t + 1]),
                "pos": jnp.asarray(t, jnp.int32)}, jc)
            lt, tc = lm.decode_step(params, {
                "tokens": torch.as_tensor(toks[:, t:t + 1]),
                "pos": torch.tensor(t, dtype=torch.int32)}, tc)
            np.testing.assert_allclose(f32(lt), f32(lj), **tol("bfloat16"))
    want = dict(_leaves(jc))
    for name, leaf in _leaves(tc):
        assert leaf.dtype == torch.float32, name
        np.testing.assert_allclose(f32(leaf), f32(want[name]),
                                   **tol("bfloat16"), err_msg=name)


def test_inactive_slots_stay_bit_identical(pair):
    """An inactive slot's mLSTM and sLSTM states come out bit-identical;
    an active slot's move."""
    _, _, lm, params, _ = pair
    caches = lm.init_caches(3, 8, vector_pos=True)
    gen = torch.Generator().manual_seed(2)
    for _, leaf in _leaves(caches):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = {k: v.clone() for k, v in _leaves(caches)}
    stacked = lm.cfg.layer_groups()[0][1] > 1
    _, new = lm.decode_step(params, {
        "tokens": torch.tensor([[3], [5], [7]]),
        "pos": torch.tensor([4, 2, 0], dtype=torch.int32),
        "active": torch.tensor([True, False, True])}, caches)
    for name, leaf in _leaves(new):
        slot = (lambda i: leaf[:, i]) if stacked else (lambda i: leaf[i])
        old = before[name][:, 1] if stacked else before[name][1]
        assert torch.equal(slot(1), old), name
        assert not torch.equal(slot(0), before[name][:, 0] if stacked
                               else before[name][0]), name


def test_cache_states_start_at_zero():
    lm = LM(_cfg()[0], device="cpu")
    caches = lm.init_caches(2, 4)
    assert isinstance(caches["group0"]["b0"], tx.MLSTMState)
    assert isinstance(caches["group1"]["b0"], tx.SLSTMState)
    assert all(float(v.abs().sum()) == 0 for _, v in _leaves(caches))
