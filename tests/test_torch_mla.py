"""MLA (``repro_torch.models.attention.mla_attention``) against the
reference's, with the same weights and inputs, in each of its three
branches: the materialised per-head form (no cache, ``S·S`` at most
``_FLASH_THRESHOLD``), the chunked form (no cache, ``S·S`` above it: bf16
q/k of width nope + rope through the chunked flash attention) and the
absorbed decode over the latent cache, with per-slot and with scalar
positions.  Then the port against itself: the absorbed decode, stepped
token by token, against the materialised form; and the per-slot cache
write, which leaves an inactive slot's latent rows bit-identical.

The outputs are bf16, held at the bf16 tolerance (2e-2); the latent
cache rows the two packages write at 2e-2 too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models.layers import ParamBuilder as JParamBuilder
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models.lm import LM
from torch_parity import f32, numpy_tree, tol

ARCHS = ["deepseek-v2-236b", "deepseek-v3-671b"]


def _noop(x, dims, site=None):
    return x


def _setup(arch="deepseek-v2-236b", seed=0):
    """The reference's MLA params of the smoke config, bridged."""
    jcfg = jget(arch, smoke=True)
    pb = JParamBuilder(jax.random.PRNGKey(seed))
    jattn.init_mla(pb, "m", jcfg)
    jp = pb.params["m"]
    tp = params_from_numpy(numpy_tree(jp), "cpu")
    return jcfg, get_config(arch, smoke=True), jp, tp


def _x(B, S, D, seed=0):
    x = np.random.default_rng(seed).standard_normal((B, S, D))
    return (jnp.asarray(x, jnp.bfloat16),
            torch.as_tensor(x.astype(np.float32)).to(torch.bfloat16))


def _positions(B, S):
    return (jnp.broadcast_to(jnp.arange(S), (B, S)),
            torch.arange(S).expand(B, S))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 16), (1, 2048)],
                         ids=["materialised", "chunked"])
def test_mla_full_sequence_matches_reference(arch, B, S):
    jcfg, cfg, jp, tp = _setup(arch)
    jx, tx = _x(B, S, cfg.d_model)
    jpos, tpos = _positions(B, S)
    want, jc = jax.jit(lambda x, p: jattn.mla_attention(
        x, p, jcfg, jpos, _noop))(jx, jp)
    got, tc = tattn.mla_attention(tx, tp, cfg, tpos, _noop)
    assert jc is None and tc is None
    assert (S * S > tattn._FLASH_THRESHOLD) == (S == 2048)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (
        B, S, cfg.d_model)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def _latent_cache(cfg, B, S_max, pos, seed=1):
    """A latent cache of random rows at ``pos`` in both packages."""
    m = cfg.mla
    lat = np.random.default_rng(seed).standard_normal(
        (B, S_max, m.kv_lora + m.rope_dim)).astype(np.float32)
    jc = jattn.KVCache(jnp.asarray(lat, jnp.bfloat16), None,
                       jnp.asarray(pos, jnp.int32))
    tc = tattn.KVCache(torch.as_tensor(lat).to(torch.bfloat16), None,
                       torch.as_tensor(np.asarray(pos), dtype=torch.int32))
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pos", [[3, 9], 5, 14],
                         ids=["per-slot", "scalar", "scalar-clamped"])
def test_mla_absorbed_decode_matches_reference(arch, pos):
    """One decode step over a filled latent cache of 12 positions: the
    output and the cache written (in place, in the port) match the
    reference's; a scalar position past the end writes the last row, as
    ``dynamic_update_slice`` clamps it."""
    B, S_max = 2, 12
    jcfg, cfg, jp, tp = _setup(arch)
    jx, tx = _x(B, 1, cfg.d_model, seed=2)
    jc, tc = _latent_cache(cfg, B, S_max, pos)
    p = np.asarray(pos)
    jpos = jnp.asarray(p[:, None] if p.ndim else np.full((B, 1), p))
    tpos = torch.as_tensor(np.array(jpos))
    want, jnew = jattn.mla_attention(jx, jp, jcfg, jpos, _noop, cache=jc)
    lat = tc.k
    got, tnew = tattn.mla_attention(tx, tp, cfg, tpos, _noop, cache=tc)
    assert tnew.k is lat and tnew.v is None
    np.testing.assert_array_equal(tnew.pos.numpy(), np.asarray(jnew.pos))
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    np.testing.assert_allclose(f32(tnew.k), f32(jnew.k), **tol("bfloat16"))
    # only the written rows changed
    _, fresh = _latent_cache(cfg, B, S_max, pos)
    changed = (tnew.k != fresh.k).any(-1)
    rows = np.zeros((B, S_max), bool)
    at = p if p.ndim else np.full(B, min(int(p), S_max - 1))
    rows[np.arange(B), at] = True
    assert np.array_equal(changed.numpy(), rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_absorbed_decode_matches_materialised(arch):
    """The port's absorbed decode, token by token from an empty latent
    cache, against its materialised form on the whole sequence, at
    ``tests/test_models.py``'s decode-vs-parallel tolerance."""
    B, S = 2, 16
    _, cfg, _, tp = _setup(arch, seed=3)
    _, tx = _x(B, S, cfg.d_model, seed=3)
    full, _ = tattn.mla_attention(tx, tp, cfg, _positions(B, S)[1], _noop)
    m = cfg.mla
    cache = tattn.KVCache(torch.zeros(B, S, m.kv_lora + m.rope_dim,
                                      dtype=torch.bfloat16), None,
                          torch.tensor(0, dtype=torch.int32))
    outs = []
    for t in range(S):
        out, cache = tattn.mla_attention(
            tx[:, t:t + 1], tp, cfg, torch.full((B, 1), t), _noop,
            cache=cache)
        outs.append(out)
    stepped = torch.cat(outs, dim=1)
    assert int(cache.pos) == S
    np.testing.assert_allclose(f32(stepped), f32(full), atol=0.25, rtol=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_slot_latent_rows_stay_bit_identical(arch):
    """``LM.decode_step`` with per-slot positions and ``active``: the
    inactive slot's latent rows and position come out bit-identical, in
    the single layers and in the stacked group, and each active slot's
    row at its position is written in place."""
    lm = LM(get_config(arch, smoke=True), device="cpu")
    params, _ = lm.init(1)
    caches = lm.init_caches(3, 20, vector_pos=True)
    gen = torch.Generator().manual_seed(1)
    pos = torch.tensor([4, 9, 0], dtype=torch.int32)
    for g in caches.values():
        g["b0"].k.copy_(torch.randn(g["b0"].k.shape, generator=gen))
        g["b0"] = g["b0"]._replace(pos=pos.expand_as(g["b0"].pos).clone())
    before = {gi: g["b0"].k.clone() for gi, g in caches.items()}
    _, new = lm.decode_step(params, {
        "tokens": torch.tensor([[3], [5], [7]]), "pos": pos,
        "active": torch.tensor([True, False, True])}, caches)
    for gi, (_, repeats) in enumerate(lm._groups()):
        got = new[f"group{gi}"]["b0"]
        assert got.k is caches[f"group{gi}"]["b0"].k and got.v is None
        old = before[f"group{gi}"]
        if repeats == 1:
            got_k, old_k, got_pos = got.k[None], old[None], got.pos[None]
        else:
            got_k, old_k, got_pos = got.k, old, got.pos
        assert torch.equal(got_k[:, 1], old_k[:, 1])
        assert (got_pos[:, 1] == 9).all()
        assert (got_pos[:, 0] == 5).all() and (got_pos[:, 2] == 1).all()
        for slot, at in ((0, 4), (2, 0)):
            moved = (got_k[:, slot] != old_k[:, slot]).any(-1)
            assert moved[:, at].all()
            moved[:, at] = False
            assert not moved.any()

