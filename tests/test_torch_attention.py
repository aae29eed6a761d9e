"""``repro_torch.models.attention`` (the GQA half) against
``repro.models.attention``: masks, ``_sdpa``, the chunked plain flash
path, and ``gqa_attention`` with and without a KV cache.  Its
cross-attention (``kv_x``) is held in ``test_torch_frontends.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from torch_parity import DTYPES, both, f32, tol


def _noop(t, dims, site=None):
    return t


def _jgqa(x, p, cfg, positions, cache=None, use_kernels=False):
    """The reference's ``gqa_attention``, jitted (one compile instead of
    dispatching each op)."""
    return jax.jit(lambda x, p, pos, c: JA.gqa_attention(
        x, p, cfg, pos, _noop, cache=c, use_kernels=use_kernels))(
            x, p, positions, cache)


@pytest.mark.parametrize("window", [None, 16])
def test_decode_mask_scalar_and_vector(window):
    Skv = 40
    for pos in (0, 7, 16, 39):
        want = JA.decode_mask(Skv, jnp.asarray(pos, jnp.int32), window)
        got = TA.decode_mask(Skv, torch.tensor(pos, dtype=torch.int32),
                             window)
        assert tuple(got.shape) == (1, 1, 1, 1, Skv)
        assert np.array_equal(got.numpy(), np.asarray(want))
    vec = np.array([0, 5, 17, 39, 22], np.int32)
    want = JA.decode_mask(Skv, jnp.asarray(vec), window)
    got = TA.decode_mask(Skv, torch.as_tensor(vec), window)
    assert tuple(got.shape) == (5, 1, 1, 1, Skv)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,q_offset", [(None, 0), (16, 0), (5, 3)])
def test_causal_mask(window, q_offset):
    want = JA.causal_mask(12, 20, window, q_offset)
    got = TA.causal_mask(12, 20, window, q_offset)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa(dtype):
    rng = np.random.default_rng(0)
    qj, qt = both(rng.normal(size=(2, 10, 6, 16)), dtype)
    kj, kt = both(rng.normal(size=(2, 14, 2, 16)), dtype)
    vj, vt = both(rng.normal(size=(2, 14, 2, 16)), dtype)
    mj = JA.causal_mask(10, 14, 6, q_offset=4)
    mt = TA.causal_mask(10, 14, 6, q_offset=4)
    want = JA._sdpa(qj, kj, vj, mj)
    got = TA._sdpa(qt, kt, vt, mt)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window,S", [
    (True, None, 128), (True, 40, 128), (False, None, 96),
    (True, None, 100),          # ragged: both fall back to _sdpa
])
def test_plain_flash_matches_flash_jnp(dtype, causal, window, S):
    rng = np.random.default_rng(S)
    qj, qt = both(rng.normal(size=(2, S, 4, 16)), dtype)
    kj, kt = both(rng.normal(size=(2, S, 2, 16)), dtype)
    vj, vt = both(rng.normal(size=(2, S, 2, 16)), dtype)
    kw = dict(causal=causal, window=window, q_block=32, kv_block=32)
    want = JA.flash_attention_jnp(qj, kj, vj, **kw)
    got = TA.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def _params(cfg, rng):
    D, H, KVH, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    shapes = {"w_q": (D, H, Dh), "w_kv": (D, 2, KVH, Dh),
              "w_o": (H, Dh, D)}
    pj, pt = {}, {}
    for name, shape in shapes.items():
        pj[name], pt[name] = both(rng.normal(size=shape) / np.sqrt(
            shape[0]), "bfloat16")
    return pj, pt


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-3-4b",
                                  "stablelm-3b"])
def test_gqa_attention_full_sequence(arch, use_kernels):
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    pj, pt = _params(cfg, rng)
    B, S = 2, 32
    xj, xt = both(rng.normal(size=(B, S, cfg.d_model)), "bfloat16")
    posj = jnp.broadcast_to(jnp.arange(S), (B, S))
    post = torch.arange(S).expand(B, S)
    want, _ = _jgqa(xj, pj, jcfg, posj, use_kernels=use_kernels)
    got, cache = TA.gqa_attention(xt, pt, cfg, post, _noop,
                                  use_kernels=use_kernels)
    assert cache is None and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def _cache_pair(cfg, B, S_max, pos, rng):
    KVH, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kj, kt = both(rng.normal(size=(B, S_max, KVH, Dh)), "bfloat16")
    vj, vt = both(rng.normal(size=(B, S_max, KVH, Dh)), "bfloat16")
    pos = np.asarray(pos, np.int32)
    return (JA.KVCache(kj, vj, jnp.asarray(pos)),
            TA.KVCache(kt, vt, torch.as_tensor(pos)))


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-3-4b"])
def test_gqa_attention_decode_scalar_position(arch):
    """Lock-step decode: S new tokens written at ``pos`` for every row."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(2)
    pj, pt = _params(cfg, rng)
    B, S_max = 2, 24
    for pos, S in ((0, 3), (20, 1)):
        cj, ct = _cache_pair(cfg, B, S_max, pos, rng)
        xj, xt = both(rng.normal(size=(B, S, cfg.d_model)), "bfloat16")
        positions = pos + np.arange(S)[None].repeat(B, 0)
        want, nj = _jgqa(xj, pj, jcfg, jnp.asarray(positions), cj)
        got, nt = TA.gqa_attention(xt, pt, cfg, torch.as_tensor(positions),
                                   _noop, cache=ct)
        np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
        np.testing.assert_allclose(f32(nt.k), f32(nj.k), **tol("bfloat16"))
        np.testing.assert_allclose(f32(nt.v), f32(nj.v), **tol("bfloat16"))
        assert int(nt.pos) == int(nj.pos) == pos + S


@pytest.mark.parametrize("arch", ["smollm-135m", "h2o-danube-3-4b"])
def test_gqa_attention_decode_per_slot(arch):
    """Continuous batching: each row scatters its token at its own
    position; an inactive row's cache is left bit-identical."""
    jcfg, cfg = jget(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(3)
    pj, pt = _params(cfg, rng)
    B, S_max = 4, 40
    pos = np.array([0, 17, 39, 5], np.int32)
    cj, ct = _cache_pair(cfg, B, S_max, pos, rng)
    xj, xt = both(rng.normal(size=(B, 1, cfg.d_model)), "bfloat16")
    want, nj = _jgqa(xj, pj, jcfg, jnp.asarray(pos[:, None]), cj)
    old_k, old_v = ct.k.clone(), ct.v.clone()
    ungated = TA.KVCache(ct.k.clone(), ct.v.clone(), ct.pos)
    got, _ = TA.gqa_attention(xt, pt, cfg, torch.as_tensor(pos[:, None]),
                              _noop, cache=ungated)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    active = torch.tensor([True, False, True, True])
    got, nt = TA.gqa_attention(xt, pt, cfg, torch.as_tensor(pos[:, None]),
                               _noop, cache=ct, active=active)
    # an inactive row's output is discarded by the caller
    np.testing.assert_allclose(f32(got[active]), f32(want)[active.numpy()],
                               **tol("bfloat16"))
    assert np.array_equal(nt.pos.numpy(), np.asarray(nj.pos))
    for r in range(B):
        if active[r]:
            np.testing.assert_allclose(f32(nt.k[r]), f32(nj.k[r]),
                                       **tol("bfloat16"))
            np.testing.assert_allclose(f32(nt.v[r]), f32(nj.v[r]),
                                       **tol("bfloat16"))
        else:
            assert torch.equal(nt.k[r], old_k[r])
            assert torch.equal(nt.v[r], old_v[r])

