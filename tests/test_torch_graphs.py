"""The port's compiled serving steps (``launch/graphs.py``) in their CPU
form, and the capture repairs they needed.

On the CPU a ``StepGraph`` runs ``decode_step`` directly against its
static inputs, caches and logits, so these tests hold the in-place
bookkeeping that a CUDA graph replays: the graph-form serving paths give
the eager path's greedy tokens and the reference's (run op by op, where
the two packages compute the same bits), and the static caches advance
as the eager step's do.  The captures themselves run on the card
(``tests/test_torch_gpu.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import scheduler as JS
from repro.models.lm import LM as JLM
from repro_torch.configs import get_config
from repro_torch.launch import graphs
from repro_torch.launch import scheduler as TS
from repro_torch.models import layers, moe
from repro_torch.models.lm import LM, _map_cache
from torch_parity import numpy_tree

S_MAX = 32


def _pair(arch):
    jlm = JLM(jget(arch, smoke=True), remat="none")
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    lm = LM(get_config(arch, smoke=True), use_kernels=True, device="cpu")
    return jlm, jparams, lm, lm.load_params(numpy_tree(jparams))


def _requests(mod, cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(3, 9)))
        out.append(mod.Request(rid=i, prompt_len=len(prompt),
                               max_new=int(rng.integers(4, 7)),
                               prompt=prompt.astype(np.int32)))
    return out


def _batcher(lm, params, reqs, graphs_on):
    b = TS.ContinuousBatcher(lm, params, slots=2, s_max=S_MAX,
                             graphs=graphs_on)
    for r in reqs:
        b.submit(r.prompt, r.max_new)
    return b.run()


@pytest.mark.parametrize("arch,path", [("smollm-135m", "batcher"),
                                       ("xlstm-125m", "batcher"),
                                       ("jamba-v0.1-52b", "static"),
                                       ("deepseek-v2-236b", "static"),
                                       ("deepseek-v3-671b", "static")])
def test_graph_form_serving_matches_eager_and_reference(arch, path):
    """Greedy tokens through the direct ``StepGraph`` form equal the
    eager path's and the reference's, token for token: the dense and
    xLSTM configs through the batcher (three requests, two slots, so a
    slot is reused), jamba and deepseek (MoE) through ``run_static`` (one
    wave of two; deepseek's MLA decodes in its absorbed form over the
    latent cache)."""
    jlm, jparams, lm, params = _pair(arch)
    n = 3 if path == "batcher" else 2
    if path == "batcher":
        got = _batcher(lm, params, _requests(TS, lm.cfg, n, 1), None)
        eager = _batcher(lm, params, _requests(TS, lm.cfg, n, 1), False)
        with jax.disable_jit():
            want = [JS.decode_offline(jlm, jparams, r, seed=0, s_max=S_MAX)
                    for r in _requests(JS, lm.cfg, n, 1)]
    else:
        got, eager = (TS.run_static(lm, params, _requests(TS, lm.cfg, n, 1),
                                    seed=0, s_max=S_MAX, graphs=g)
                      for g in (None, False))
        with jax.disable_jit():
            want = [r.out for r in JS.run_static(
                jlm, jparams, _requests(JS, lm.cfg, n, 1), seed=0,
                s_max=S_MAX).requests]
    by_rid = {r.rid: r.out for r in got.requests}
    assert [by_rid[i] for i in range(n)] == want
    assert {r.rid: r.out for r in eager.requests} == by_rid
    assert got.generated == sum(len(w) for w in want)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("arch,vector_pos", [("smollm-135m", True),
                                             ("xlstm-125m", True),
                                             ("jamba-v0.1-52b", False),
                                             ("deepseek-v2-236b", True),
                                             ("deepseek-v3-671b", False)])
def test_static_caches_advance_as_the_eager_step(arch, vector_pos):
    """After N runs the static caches equal the eager ``decode_step``'s
    caches leaf for leaf, bit for bit, as do the logits; with per-slot
    positions, the slot held inactive throughout stays bit-identical."""
    lm = LM(get_config(arch, smoke=True), use_kernels=True, device="cpu")
    params, _ = lm.init(0)
    B, steps = 3, 4
    g = graphs.StepGraph(lm, params, B, S_MAX, vector_pos)
    assert g.graph is None                   # the direct form on the CPU
    gen = torch.Generator().manual_seed(0)
    # non-zero starting state, the same in both
    for _, a in _leaves(g.caches):
        if a.is_floating_point():
            a.copy_(torch.randn(a.shape, generator=gen).to(a.dtype))
    caches = _map_cache(torch.clone, g.caches)
    before = _map_cache(torch.clone, g.caches)
    active = torch.tensor([True, False, True])
    pos = torch.tensor([2, 5, 0], dtype=torch.int32)
    for t in range(steps):
        toks = torch.randint(0, lm.cfg.vocab, (B, 1), generator=gen)
        if vector_pos:
            batch = {"tokens": toks, "pos": pos + t, "active": active}
            got = g.run(toks, pos + t, active)
        else:
            batch = {"tokens": toks,
                     "pos": torch.tensor(t, dtype=torch.int32)}
            got = g.run(toks, t)
        want, caches = lm.decode_step(params, batch, caches)
        assert torch.equal(got, want)
    for gi, (_pattern, repeats) in enumerate(lm._groups()):
        grp = f"group{gi}"
        for (path, a), (_, b), (_, a0) in zip(_leaves(g.caches[grp], grp),
                                              _leaves(caches[grp]),
                                              _leaves(before[grp])):
            assert torch.equal(a, b), path
            if vector_pos:
                ax = 1 if repeats > 1 else 0
                assert torch.equal(a.select(ax, 1), a0.select(ax, 1)), path
    g.reset()
    assert all(not v.any() for _, v in _leaves(g.caches))


def test_step_graph_memo():
    """One graph per (model, B, s_max, vector_pos, use, params), kept
    until ``release``; the batcher's slot batch and its prefill group of
    the same width are two."""
    lm = LM(get_config("smollm-135m", smoke=True), device="cpu")
    params, _ = lm.init(0)
    other, _ = lm.init(1)
    try:
        a = graphs.step_graph(lm, params, 2, S_MAX, True, use="slots")
        assert graphs.step_graph(lm, params, 2, S_MAX, True,
                                 use="slots") is a
        for g in (graphs.step_graph(lm, params, 2, S_MAX, True,
                                    use="prefill"),
                  graphs.step_graph(lm, params, 3, S_MAX, True),
                  graphs.step_graph(lm, other, 2, S_MAX, True, use="slots"),
                  graphs.step_graph(LM(lm.cfg, device="cpu"), params, 2,
                                    S_MAX, True, use="slots")):
            assert g is not a
        assert a.params is params and a.lm is lm
    finally:
        graphs.release()
    assert graphs.step_graph(lm, params, 2, S_MAX, True, use="slots") is not a
    graphs.release()


def test_graphs_refuse_a_replaced_router(monkeypatch):
    """A graph of an MoE model would replay the routing of its capture,
    so a replaced ``router_topk`` is refused; a dense model has none."""
    jamba = LM(get_config("jamba-v0.1-52b", smoke=True), device="cpu")
    dense = LM(get_config("smollm-135m", smoke=True), device="cpu")
    graphs._refuse_patched(jamba)
    monkeypatch.setattr(moe, "router_topk", lambda *a: moe.ROUTER_TOPK(*a))
    with pytest.raises(RuntimeError, match="router_topk is replaced"):
        graphs._refuse_patched(jamba)
    graphs._refuse_patched(dense)


@pytest.mark.parametrize("rot_dim,base", [(64, 10000.0), (20, 500000.0)])
def test_rope_angles_reuse_their_frequencies(rot_dim, base):
    """The inverse frequencies are built once per (rot_dim, base,
    device), and the angles keep the bits of building them every call."""
    pos = torch.arange(0, 4096, 37).reshape(1, -1)
    cos, sin = layers.rope_angles(pos, rot_dim, base)
    inv = 1.0 / (base ** (np.arange(0, rot_dim, 2) / rot_dim))
    ang = pos[..., None].float() * torch.tensor(inv, dtype=torch.float32)
    assert torch.equal(cos, torch.cos(ang))
    assert torch.equal(sin, torch.sin(ang))
    first = layers._INV_FREQ[(rot_dim, base, pos.device)]
    layers.rope_angles(pos[:, :3], rot_dim, base)
    assert layers._INV_FREQ[(rot_dim, base, pos.device)] is first


@pytest.mark.parametrize("E,n", [(16, 7), (8, 64), (4, 0)])
def test_expert_counts_equal_bincount(E, n):
    """The fixed-size count of expert ids equals ``torch.bincount`` at
    ``minlength=E``, empty experts included."""
    gen = torch.Generator().manual_seed(n)
    ids = torch.randint(0, max(E // 2, 1), (n,), generator=gen) * 2
    got = moe.expert_counts(ids, E)
    want = torch.bincount(ids, minlength=E)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert (got == 0).any()
