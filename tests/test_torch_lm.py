"""``repro_torch.models.lm.LM`` against ``repro.models.lm.LM`` with the
reference's params bridged in: ``logits_fn``, ``prefill`` (kernels on and
off) and lock-step decode, on the dense smoke configs.  The xLSTM family
has its own file, ``test_torch_xlstm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from torch_parity import f32, numpy_tree, tol

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
                                  "stablelm-3b", "xlstm-125m"])
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


@pytest.mark.parametrize("arch,item", [
    ("deepseek-v2-236b", "A9"), ("jamba-v0.1-52b", "A10"),
    ("musicgen-large", "A4"), ("llama-3.2-vision-11b", "A4"),
])
def test_unported_families_raise(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        LM(get_config(arch, smoke=True), device="cpu")


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
