"""``repro_torch.models.lm.LM`` against ``repro.models.lm.LM`` with the
reference's params bridged in: ``logits_fn``, ``prefill`` (kernels on and
off) and lock-step decode, on the dense smoke configs, on jamba's
(Mamba + MoE + GQA) and on deepseek-v2's and deepseek-v3's (MLA + MoE).
The xLSTM family has its own file, ``test_torch_xlstm.py``.

The jamba cases compare with the reference run op by op
(``jax.disable_jit``), as ``test_torch_xlstm.py`` does; with kernels, the
reference's Pallas selective scan runs in interpret mode.  Even op by op
the two packages' f32 ``exp`` and ``softplus`` differ in the last place
on some inputs, so a bf16 activation can round one step apart.  At 8
layers the logits agree to the bf16 tolerance as they stand.  At 16 the
expert weights (std 1/sqrt(E) = 0.5 here) grow such a step until one
token's router choice flips in the last MoE layer (on these inputs: token
4 of row 0, whose first Mamba output rounds one bf16 step apart), and a
top-k choice is discontinuous.  So the 16-layer cases replay the
reference's expert ids in the port (``RouterPin``), hold the logits to
the same bf16 tolerance, and bound the number of choices the port's own
router would have moved."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.models.ssm import SSMState
from torch_parity import RouterPin, f32, numpy_tree, tol

PARITY_ARCHS = ["smollm-135m", "smollm-360m", "h2o-danube-3-4b"]
B, S = 2, 24


@pytest.fixture(scope="module", params=PARITY_ARCHS)
def pair(request):
    arch = request.param
    jlm = JLM(jget(arch, smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config(arch, smoke=True), device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    toks = np.random.default_rng(0).integers(0, lm.cfg.vocab, (B, S))
    return jlm, jparams, lm, params, toks


def _jbatch(toks):
    return {"tokens": jnp.asarray(toks, jnp.int32)}


def _tbatch(toks):
    return {"tokens": torch.as_tensor(toks)}


def test_logits_fn(pair):
    jlm, jparams, lm, params, toks = pair
    want = jax.jit(jlm.logits_fn)(jparams, _jbatch(toks))
    got = lm.logits_fn(params, _tbatch(toks))
    assert tuple(got.shape) == (B, S, lm.cfg.vocab)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill(pair, use_kernels):
    jlm, jparams, lm, params, toks = pair
    jk = JLM(jlm.cfg, remat="none", use_kernels=use_kernels)
    want = jax.jit(jk.prefill)(jparams, _jbatch(toks))
    tk = LM(lm.cfg, use_kernels=use_kernels, device="cpu")
    got = tk.prefill(params, _tbatch(toks))
    # the reference returns the last position's logits only
    assert tuple(got.shape) == (B, 1, lm.cfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    assert torch.equal(got, tk.logits_fn(params, _tbatch(toks))[:, -1:])


def test_scalar_decode_steps(pair):
    jlm, jparams, lm, params, toks = pair
    jc = jlm.init_caches(B, S)
    tc = lm.init_caches(B, S)
    step = jax.jit(jlm.decode_step)
    for t in range(8):
        lj, jc = step(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1],
                                                      jnp.int32),
                                "pos": jnp.asarray(t, jnp.int32)}, jc)
        lt, tc = lm.decode_step(params, {
            "tokens": torch.as_tensor(toks[:, t:t + 1]),
            "pos": torch.tensor(t, dtype=torch.int32)}, tc)
        np.testing.assert_allclose(f32(lt), f32(lj), **tol("bfloat16"))
    kj = jc["group0"]["b0"]
    kt = tc["group0"]["b0"]
    assert tuple(kt.k.shape) == tuple(kj.k.shape)
    assert np.array_equal(kt.pos.numpy(), np.asarray(kj.pos))
    np.testing.assert_allclose(f32(kt.k), f32(kj.k), **tol("bfloat16"))


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-3-4b",
                                  "stablelm-3b", "xlstm-125m",
                                  "jamba-v0.1-52b", "deepseek-v2-236b",
                                  "deepseek-v3-671b"])
def test_decode_matches_parallel(arch):
    """The reference's ``test_decode_matches_parallel``, on the port:
    stepping one token at a time through the cache reproduces the
    teacher-forced logits."""
    lm = LM(get_config(arch, smoke=True), device="cpu")
    params, _ = lm.init(0)
    toks = torch.randint(0, lm.cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    full = f32(lm.logits_fn(params, {"tokens": toks}))
    caches = lm.init_caches(2, 12)
    outs = []
    for t in range(12):
        logits, caches = lm.decode_step(params, {
            "tokens": toks[:, t:t + 1],
            "pos": torch.tensor(t, dtype=torch.int32)}, caches)
        outs.append(f32(logits[:, 0]))
    stepped = np.stack(outs, axis=1)
    np.testing.assert_allclose(stepped, full, atol=0.25, rtol=0.1)
    assert np.mean(stepped.argmax(-1) == full.argmax(-1)) > 0.9


def test_inactive_slots_stay_bit_identical():
    lm = LM(get_config("h2o-danube-3-4b", smoke=True), device="cpu")
    params, _ = lm.init(1)
    caches = lm.init_caches(3, 20, vector_pos=True)
    gen = torch.Generator().manual_seed(1)
    for leaf in (caches["group0"]["b0"].k, caches["group0"]["b0"].v):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    caches["group0"]["b0"] = caches["group0"]["b0"]._replace(
        pos=torch.tensor([[4, 9, 0], [4, 9, 0]], dtype=torch.int32))
    before = {k: t.clone() for k, t in
              caches["group0"]["b0"]._asdict().items()}
    active = torch.tensor([True, False, True])
    _, new = lm.decode_step(params, {
        "tokens": torch.tensor([[3], [5], [7]]),
        "pos": torch.tensor([4, 9, 0], dtype=torch.int32),
        "active": active}, caches)
    got = new["group0"]["b0"]
    # stacked group: axis 0 is layers, axis 1 the slot
    for name in ("k", "v", "pos"):
        assert torch.equal(getattr(got, name)[:, 1], before[name][:, 1])
        assert not torch.equal(getattr(got, name)[:, 0], before[name][:, 0])
    assert got.pos[:, 0].tolist() == [5, 5] and got.pos[:, 2].tolist() == [1, 1]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_xlstm_builds_and_runs_on_cpu(use_kernels):
    """xLSTM is ported: the smoke model builds, prefills and decodes."""
    lm = LM(get_config("xlstm-125m", smoke=True), use_kernels=use_kernels,
            device="cpu")
    params, _ = lm.init(0)
    toks = torch.randint(0, lm.cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    last = lm.prefill(params, {"tokens": toks})
    assert tuple(last.shape) == (2, 1, lm.cfg.vocab)
    assert torch.isfinite(last.float()).all()
    logits, caches = lm.decode_step(params, {
        "tokens": toks[:, :1], "pos": torch.tensor(0, dtype=torch.int32)},
        lm.init_caches(2, 16))
    assert tuple(logits.shape) == (2, 1, lm.cfg.vocab)
    assert set(caches) == {"group0", "group1", "group2"}


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(get_config("smollm-135m", smoke=True))


# -- jamba (Mamba + MoE + GQA) ------------------------------------------------

JB, JS = 2, 32          # JS a multiple of the smoke Mamba chunk (16)


def _jamba_cfgs(n_layers=None):
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    jcfg = jget("jamba-v0.1-52b", smoke=True)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    return cfg, jcfg


@pytest.fixture(scope="module", params=[None, 16], ids=["8L", "16L"])
def jamba(request):
    """The jamba smoke config (8 layers: four single layers, then one
    group of four) and its 16-layer variant, whose layers form one
    stacked group of the 8-layer pattern × 2, as the 32-layer model's
    do × 4."""
    cfg, jcfg = _jamba_cfgs(request.param)
    jlm = JLM(jcfg, remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(cfg, device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (JB, JS))
    return jlm, jparams, lm, params, toks


def _tree_specs(tree):
    if isinstance(tree, dict):
        return {k: _tree_specs(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype))


def test_jamba_layer_groups():
    cfg16, _ = _jamba_cfgs(16)
    pattern, repeats = cfg16.layer_groups()[0]
    assert repeats == 2 and len(cfg16.layer_groups()) == 1
    assert [m for m, _ in pattern] == ["mamba"] * 3 + ["attn"] + \
        ["mamba"] * 4
    assert [f for _, f in pattern] == ["dense", "moe"] * 4


def test_jamba_param_tree_matches_reference(jamba):
    jlm, jparams, lm, params, _ = jamba
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    assert _tree_specs(lm.param_shapes()) == jax.tree.map(
        lambda sd: (sd[0], "torch." + sd[1]), want,
        is_leaf=lambda x: isinstance(x, tuple))
    assert _tree_specs(params) == _tree_specs(lm.param_shapes())


def _jamba_pair(lm, ref_fn, port_fn):
    """``ref_fn()`` op by op and ``port_fn()``, compared at the bf16
    tolerance; at 16 layers with the reference's expert choices replayed
    in the port, which would move at most one token on its own."""
    pin = RouterPin()
    deep = lm.cfg.n_layers > 8
    with jax.disable_jit(), \
            pin.recording() if deep else contextlib.nullcontext():
        want = ref_fn()
    with pin.replaying() if deep else contextlib.nullcontext():
        got = port_fn()
    logits = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(f32(logits), f32(want), **tol("bfloat16"))
    if deep:
        assert len(pin.ids) == lm.cfg.n_layers // 2 and pin.moved <= 1
    return got


def test_jamba_logits_fn(jamba):
    jlm, jparams, lm, params, toks = jamba
    got = _jamba_pair(lm, lambda: jlm.logits_fn(jparams, _jbatch(toks)),
                      lambda: lm.logits_fn(params, _tbatch(toks)))
    assert tuple(got.shape) == (JB, JS, lm.cfg.vocab)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_jamba_prefill(jamba, use_kernels):
    jlm, jparams, lm, params, toks = jamba
    jk = JLM(jlm.cfg, remat="none", use_kernels=use_kernels)
    tk = LM(lm.cfg, use_kernels=use_kernels, device="cpu")
    got, aux = _jamba_pair(
        lm, lambda: jk.prefill(jparams, _jbatch(toks)),
        lambda: tk.prefill(params, _tbatch(toks), with_aux=True))
    assert tuple(got.shape) == (JB, 1, lm.cfg.vocab)
    n_moe = sum(f == "moe" for _, f in lm.cfg.layer_kinds())
    assert aux.load_balance_loss > 0 and 0 <= aux.dropped_fraction < 1
    assert torch.equal(got, tk.prefill(params, _tbatch(toks)))
    assert n_moe == lm.cfg.n_layers // 2


def test_jamba_decode_steps_like_scan():
    """The stacked 16-layer variant, stepped in both packages: the loop
    over the layers axis carries and restacks the Mamba states and conv
    carries as ``lax.scan`` does."""
    cfg, jcfg = _jamba_cfgs(16)
    jlm = JLM(jcfg, remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(1))
    lm = LM(cfg, device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (JB, 6))
    jc, tc = jlm.init_caches(JB, 8), lm.init_caches(JB, 8)
    with jax.disable_jit():
        for t in range(6):
            lj, jc = jlm.decode_step(jparams, {
                "tokens": jnp.asarray(toks[:, t:t + 1], jnp.int32),
                "pos": jnp.asarray(t, jnp.int32)}, jc)
            lt, tc = lm.decode_step(params, {
                "tokens": torch.as_tensor(toks[:, t:t + 1]),
                "pos": torch.tensor(t, dtype=torch.int32)}, tc)
            np.testing.assert_allclose(f32(lt), f32(lj), **tol("bfloat16"))
    (sj, cj), (st, ct) = jc["group0"]["b0"], tc["group0"]["b0"]
    assert isinstance(st, SSMState) and tuple(st.h.shape) == (
        2, JB, 2 * cfg.d_model, cfg.mamba.d_state)
    assert tuple(ct.shape) == tuple(cj.shape) and ct.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(st.h), f32(sj.h), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(ct), f32(cj), **tol("bfloat16"))
    kv = tc["group0"]["b3"]
    assert kv.pos.tolist() == [6, 6]


def test_jamba_inactive_slots_stay_bit_identical():
    cfg, _ = _jamba_cfgs(16)
    lm = LM(cfg, device="cpu")
    params, _ = lm.init(2)
    caches = lm.init_caches(3, 12, vector_pos=True)
    gen = torch.Generator().manual_seed(2)
    state, carry = caches["group0"]["b0"]
    for leaf in (state.h, carry):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = [t.clone() for t in (state.h, carry)]
    _, new = lm.decode_step(params, {
        "tokens": torch.tensor([[3], [5], [7]]),
        "pos": torch.tensor([4, 9, 0], dtype=torch.int32),
        "active": torch.tensor([True, False, True])}, caches)
    got_state, got_carry = new["group0"]["b0"]
    # stacked group: axis 0 is layers, axis 1 the slot
    for got, old in zip((got_state.h, got_carry), before):
        assert torch.equal(got[:, 1], old[:, 1])
        assert not torch.equal(got[:, 0], old[:, 0])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_jamba_builds_and_runs_on_cpu(use_kernels):
    """Mamba + MoE is ported: the smoke model builds, prefills and
    decodes."""
    lm = LM(get_config("jamba-v0.1-52b", smoke=True),
            use_kernels=use_kernels, device="cpu")
    params, _ = lm.init(0)
    toks = torch.randint(0, lm.cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    last = lm.prefill(params, {"tokens": toks})
    assert tuple(last.shape) == (2, 1, lm.cfg.vocab)
    assert torch.isfinite(last.float()).all()
    logits, caches = lm.decode_step(params, {
        "tokens": toks[:, :1], "pos": torch.tensor(0, dtype=torch.int32)},
        lm.init_caches(2, 16))
    assert tuple(logits.shape) == (2, 1, lm.cfg.vocab)
    state, carry = caches["group0"]["b0"]
    assert tuple(state.h.shape) == (2, 128, 8) and tuple(carry.shape) == (
        2, 3, 128)


# -- deepseek (MLA + MoE) -----------------------------------------------------

DS_ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]


@pytest.fixture(scope="module", params=DS_ARCHS)
def deepseek(request):
    """A deepseek smoke config (a dense layer, then a stacked group of MoE
    layers; MLA in every layer) with the reference's params."""
    jcfg = jget(request.param, smoke=True)
    jlm = JLM(jcfg, remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config(request.param, smoke=True), device="cpu")
    params = lm.load_params(numpy_tree(jparams))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (JB, JS))
    return jlm, jparams, lm, params, toks


def _pinned_pair(ref_fn, port_fn):
    """``ref_fn()`` op by op, and ``port_fn()`` with the reference's
    expert choices replayed, compared at the bf16 tolerance."""
    pin = RouterPin()
    with jax.disable_jit(), pin.recording():
        want = ref_fn()
    with pin.replaying():
        got = port_fn()
    logits = got[0] if isinstance(got, tuple) else got
    np.testing.assert_allclose(f32(logits), f32(want), **tol("bfloat16"))
    return got, pin


def test_deepseek_logits_fn(deepseek):
    jlm, jparams, lm, params, toks = deepseek
    got, pin = _pinned_pair(lambda: jlm.logits_fn(jparams, _jbatch(toks)),
                            lambda: lm.logits_fn(params, _tbatch(toks)))
    assert tuple(got.shape) == (JB, JS, lm.cfg.vocab)
    assert len(pin.ids) == lm.cfg.n_layers - 1 and pin.moved <= 1


@pytest.mark.parametrize("use_kernels", [False, True])
def test_deepseek_prefill(deepseek, use_kernels):
    """Kernels on: RMSNorm at every norm site and the grouped matmul in
    every MoE FFN (their plain versions on the CPU); MLA takes no
    kernel, as the reference's does."""
    jlm, jparams, lm, params, toks = deepseek
    jk = JLM(jlm.cfg, remat="none", use_kernels=use_kernels)
    tk = LM(lm.cfg, use_kernels=use_kernels, device="cpu")
    (got, aux), _ = _pinned_pair(
        lambda: jk.prefill(jparams, _jbatch(toks)),
        lambda: tk.prefill(params, _tbatch(toks), with_aux=True))
    assert tuple(got.shape) == (JB, 1, lm.cfg.vocab)
    assert float(aux.dropped_fraction) == 0.0
