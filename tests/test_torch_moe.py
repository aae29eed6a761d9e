"""``repro_torch.models.moe`` and the grouped-matmul wrapper against the
reference.

Router, slotting and the MoE FFN take the same numpy inputs and bridged
params as ``repro.models.moe``; the FFN is compared with the reference
run op by op (``jax.disable_jit``) at the bf16 tolerance.  The plain
grouped matmul is held to the reference's Pallas kernel in interpret
mode at ``test_kernels.py``'s shapes and tolerances.

One difference is deliberate and pinned here: the reference scatters the
dropped (token, k) copies onto slot 0 with zero rows, and XLA leaves a
scatter with duplicate indices unspecified.  On the CPU the later write
wins, so slot 0 of an overflowing expert comes out zero although its
token was kept.  The port writes the kept copies only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.moe_gmm import ops as jgmm
from repro.models import moe as jmoe
from repro.models.layers import ParamBuilder as JParamBuilder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ParamBuilder
from torch_parity import DTYPES, both, f32, numpy_tree, tol


def _noop(x, dims, site=None):
    return x


def _cfgs(arch="jamba-v0.1-52b", **moe_kw):
    """The smoke config of ``arch`` on both sides, its MoE fields
    replaced by ``moe_kw``."""
    cfg, jcfg = get_config(arch, smoke=True), jget(arch, smoke=True)
    if moe_kw:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
    return cfg, jcfg


def _params(jcfg, seed=0):
    pb = JParamBuilder(jax.random.PRNGKey(seed))
    jmoe.init_moe(pb, "m", jcfg)
    jp = pb.params["m"]
    return jp, params_from_numpy(numpy_tree(jp), "cpu")


def _x(B, S, D, seed=0):
    return both(np.random.default_rng(seed).normal(size=(B, S, D)),
                "bfloat16")


# -- router and slotting -------------------------------------------------------


def test_param_tree_matches_reference():
    cfg, jcfg = _cfgs(n_shared=1)
    jp, tp = _params(jcfg)
    pb = ParamBuilder(None, device=torch.device("meta"))
    tmoe.init_moe(pb, "m", cfg)
    assert set(pb.params["m"]) == set(jp) == {
        "w_router", "w_in", "w_out", "w_shared_in", "w_shared_out"}
    for k, leaf in pb.params["m"].items():
        assert tuple(leaf.shape) == tuple(jp[k].shape), k
        assert leaf.dtype == tp[k].dtype, k
    assert tp["w_router"].dtype == torch.float32


def test_router_topk_matches_reference():
    cfg, jcfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.default_rng(1)
    xj, xt = both(rng.normal(size=(40, cfg.d_model)), "bfloat16")
    gj, ij, aj = jmoe.router_topk(xj, jp["w_router"], jcfg.moe)
    gt, it, at = tmoe.router_topk(xt, tp["w_router"], cfg.moe)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(f32(gt), f32(gj), **tol("float32"))
    for name in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(f32(getattr(at, name)),
                                   f32(getattr(aj, name)),
                                   **tol("float32"), err_msg=name)


@pytest.mark.parametrize("T,K,E,cap", [(64, 2, 8, 24), (16, 1, 2, 3),
                                       (8, 2, 4, 8)])
def test_dispatch_indices_match_reference(T, K, E, cap):
    idx = np.random.default_rng(T + E).integers(0, E, size=(T, K))
    want = jmoe.dispatch_indices(jnp.asarray(idx), E, cap)
    got = tmoe.dispatch_indices(torch.as_tensor(idx), E, cap)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_moe_dispatch_indices_invariants():
    """The reference's ``test_moe_dispatch_indices_invariants``, on the
    port."""
    rng = np.random.default_rng(2)
    T, K, E, cap = 64, 2, 8, 24
    idx = torch.as_tensor(rng.integers(0, E, size=(T, K)))
    eid, slot, keep = (t.numpy() for t in tmoe.dispatch_indices(idx, E, cap))
    assert (slot[keep] < cap).all()
    pairs = set()
    for e, s, k in zip(eid, slot, keep):
        if k:
            assert (e, s) not in pairs
            pairs.add((e, s))
    for e in range(E):
        assigned = int((eid == e).sum())
        kept = int(((eid == e) & keep).sum())
        assert kept == min(assigned, cap)


@pytest.mark.parametrize("T,want", [(1, 1), (8, 8), (64, 10), (4096, 640)])
def test_capacity_matches_reference_formula(T, want):
    """``min(T, max(ceil(T·K·cf/E), 8))`` (``moe.py:244``) at jamba's
    K=2, cf=1.25, E=16: decode (T ≤ 8) keeps every token, prefill at
    B=4, S=1024 gets 640 slots."""
    assert tmoe.capacity_of(T, get_config("jamba-v0.1-52b").moe) == want


# -- the dropped-token scatter -------------------------------------------------


def test_reference_scatter_zeroes_slot_0_of_an_overflowing_expert():
    """Expert 0 gets four tokens for two slots.  The reference's scatter
    writes the two dropped copies onto slot 0 with zero rows after the
    kept one, so its row (0, 0) is zero; the port's holds token 0.  Every
    other row agrees."""
    idx = np.array([[0], [0], [1], [0], [0], [1]])
    E, cap, D = 2, 2, 4
    x = np.arange(1, 1 + len(idx) * D, dtype=np.float32).reshape(-1, D)
    eid, slot, keep = jmoe.dispatch_indices(jnp.asarray(idx), E, cap)
    src = jnp.repeat(jnp.asarray(x), 1, axis=0)
    ref = jnp.zeros((E, cap, D), jnp.float32).at[eid, slot].set(
        jnp.where(keep[:, None], src, 0), mode="drop")   # moe.py:253-254
    ref = np.asarray(ref)
    te, ts, tk = tmoe.dispatch_indices(torch.as_tensor(idx), E, cap)
    got = tmoe.dispatch(torch.as_tensor(x), 1, te, ts, tk, E, cap).numpy()
    assert not ref[0, 0].any()
    np.testing.assert_array_equal(got[0, 0], x[0])
    np.testing.assert_array_equal(got[0, 1], x[1])
    np.testing.assert_array_equal(np.delete(got.reshape(-1, D), 0, 0),
                                  np.delete(ref.reshape(-1, D), 0, 0))


def test_moe_ffn_keeps_the_token_the_reference_zeroes():
    """End to end: every token routes to expert 0 of two (top-1,
    capacity 8 of 16 tokens).  The reference's token 0 gets nothing from
    its expert; the port's gets its output.  Tokens 1-7 agree and tokens
    8-15 are dropped by both."""
    cfg, jcfg = _cfgs(n_experts=2, top_k=1, capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=4)
    D = cfg.d_model
    w_router = np.zeros((D, 2), np.float32)
    w_router[:, 0], w_router[:, 1] = 1.0, -1.0
    jp = dict(jp, w_router=jnp.asarray(w_router))
    tp = dict(tp, w_router=torch.as_tensor(w_router))
    xj, xt = both(np.abs(np.random.default_rng(5).normal(size=(1, 16, D))),
                  "bfloat16")
    with jax.disable_jit():
        want, waux = jmoe.moe_ffn(xj, jp, jcfg, _noop)
    got, gaux = tmoe.moe_ffn(xt, tp, cfg, _noop)
    want, got = f32(want)[0], f32(got)[0]
    assert float(waux.dropped_fraction) == float(gaux.dropped_fraction) == 0.5
    assert not want[0].any() and got[0].any()
    np.testing.assert_allclose(got[1:], want[1:], **tol("bfloat16"))
    assert not got[8:].any()


# -- the MoE FFN ------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_ffn_matches_reference(use_kernels, n_shared):
    cfg, jcfg = _cfgs(n_shared=n_shared)
    jp, tp = _params(jcfg, seed=6)
    xj, xt = _x(2, 12, cfg.d_model, seed=6)
    with jax.disable_jit():
        want, waux = jmoe.moe_ffn(xj, jp, jcfg, _noop)
    got, gaux = tmoe.moe_ffn(xt, tp, cfg, _noop, use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    for name in tmoe.MoEAux._fields:
        np.testing.assert_allclose(f32(getattr(gaux, name)),
                                   f32(getattr(waux, name)),
                                   **tol("float32"), err_msg=name)


def test_moe_ffn_kernel_switch_agrees_with_drops():
    """With drops (capacity 8 for 48 copies over 4 experts) the grouped
    matmul and the einsums compute the same function."""
    cfg, _ = _cfgs(capacity_factor=0.5)
    _, tp = _params(_cfgs(capacity_factor=0.5)[1], seed=7)
    _, xt = _x(2, 12, cfg.d_model, seed=7)
    a, aux = tmoe.moe_ffn(xt, tp, cfg, _noop, use_kernels=False)
    b, _ = tmoe.moe_ffn(xt, tp, cfg, _noop, use_kernels=True)
    assert float(aux.dropped_fraction) > 0
    assert torch.equal(a, b)


def test_moe_matches_dense_reference_when_no_drop():
    """The reference's ``test_moe_matches_dense_reference_when_no_drop``,
    on the port: with capacity ≥ T·K the sort-based dispatch equals the
    brute-force dense (every-expert) weighted combination."""
    cfg, jcfg = _cfgs("deepseek-v2-236b", n_experts=4, top_k=2, n_shared=0,
                      d_expert=16, capacity_factor=8.0)
    _, p = _params(jcfg, seed=3)
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    for use_kernels in (False, True):
        out, aux = tmoe.moe_ffn(x, p, cfg, _noop, use_kernels=use_kernels)
        assert float(aux.dropped_fraction) == 0.0
        xt = x.reshape(-1, cfg.d_model)
        gate, idx, _ = tmoe.router_topk(xt, p["w_router"], cfg.moe)
        ref = np.zeros((xt.shape[0], cfg.d_model), np.float32)
        for e in range(cfg.moe.n_experts):
            h = np.einsum("td,dgf->tgf", f32(xt), f32(p["w_in"][e]))
            act = f32(torch.nn.functional.silu(torch.as_tensor(
                h[..., 0, :]))) * h[..., 1, :]
            oe = act @ f32(p["w_out"][e])
            w = np.zeros(xt.shape[0], np.float32)
            for kk in range(cfg.moe.top_k):
                w += np.where(idx[:, kk].numpy() == e,
                              f32(gate[:, kk]), 0)
            ref += w[:, None] * oe
        # bf16 expert compute vs f32 reference, at the reference's
        # tolerance for this test
        np.testing.assert_allclose(f32(out.reshape(-1, cfg.d_model)), ref,
                                   rtol=0.1, atol=0.25)


# -- the grouped matmul's plain version -----------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,D,F,cb,fb,db", [
    (4, 32, 64, 128, 16, 64, 32),
    (8, 64, 32, 64, 64, 64, 32),
])
def test_moe_gmm_matches_pallas(dtype, E, C, D, F, cb, fb, db):
    """The reference's kernel-test shapes (``test_kernels.py``)."""
    rng = np.random.default_rng(E * C + D)
    xj, xt = both(rng.normal(size=(E, C, D)), dtype)
    wj, wt = both(rng.normal(size=(E, D, F)) * 0.1, dtype)
    gs = rng.integers(0, C + 1, size=(E,)).astype(np.int32)
    gs[0], gs[-1] = 0, C
    want = jgmm.moe_gmm(xj, wj, jnp.asarray(gs), c_block=cb, f_block=fb,
                        d_block=db)
    got = tgmm.moe_gmm(xt, wt, torch.as_tensor(gs), c_block=cb,
                       f_block=fb, d_block=db)
    assert got.dtype == xt.dtype and tuple(got.shape) == (E, C, F)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    assert torch.equal(got, moe_gmm_ref(xt, wt, torch.as_tensor(gs)))
    assert not f32(got[0]).any()


def test_moe_gmm_refuses_what_the_reference_asserts():
    x, w = torch.ones(2, 24, 16), torch.ones(2, 16, 32)
    gs = torch.tensor([24, 3])
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tgmm.moe_gmm(x, w, gs, c_block=16)
    with pytest.raises(ValueError, match="shapes"):
        tgmm.moe_gmm(x, w[:, :8], gs, c_block=24, f_block=32, d_block=16)
    m = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        tgmm.moe_gmm(m, torch.empty(2, 16, 8, device="meta"),
                     torch.empty(2, device="meta"))
