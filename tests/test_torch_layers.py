"""``repro_torch.models.layers`` against ``repro.models.layers``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import layers as TL
from torch_parity import DTYPES, both, f32, tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.normal(size=(2, 5, 96)) * 3, dtype)
    sj, st = both(rng.normal(size=(96,)) + 1, "float32")
    want = JL.rms_norm(xj, sj)
    got = TL.rms_norm(xt, st)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    # use_kernels routes the same norm through the kernel's wrapper, which
    # takes the plain version for a CPU tensor and launches nothing
    before = rms_ops.rmsnorm.launches
    routed = TL.apply_norm("rms", xt, {"scale": st}, use_kernels=True)
    assert torch.equal(routed, got)
    assert rms_ops.rmsnorm.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    rng = np.random.default_rng(2)
    xj, xt = both(rng.normal(size=(3, 4, 64)) + 0.5, dtype)
    sj, st = both(rng.normal(size=(64,)) + 1, "float32")
    bj, bt = both(rng.normal(size=(64,)), "float32")
    want = JL.apply_norm("ln", xj, {"scale": sj, "bias": bj})
    for use_kernels in (False, True):
        got = TL.apply_norm("ln", xt, {"scale": st, "bias": bt},
                            use_kernels=use_kernels)
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def test_rope_angles():
    pos = np.arange(40).reshape(2, 20) * 37
    cj, sj = JL.rope_angles(jnp.asarray(pos), 64)
    ct, st = TL.rope_angles(torch.as_tensor(pos), 64)
    assert ct.dtype == torch.float32 and tuple(ct.shape) == (2, 20, 32)
    np.testing.assert_allclose(f32(ct), f32(cj), **tol("float32"))
    np.testing.assert_allclose(f32(st), f32(sj), **tol("float32"))


@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype, rope_pct):
    rng = np.random.default_rng(3)
    Dh = 32
    rot = int(Dh * rope_pct) & ~1
    xj, xt = both(rng.normal(size=(2, 7, 3, Dh)), dtype)
    pos = rng.integers(0, 500, size=(2, 7))
    cj, sj = JL.rope_angles(jnp.asarray(pos), rot)
    ct, st = TL.rope_angles(torch.as_tensor(pos), rot)
    want = JL.apply_rope(xj, cj, sj, rot)
    got = TL.apply_rope(xt, ct, st, rot)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    # the pass-through features are untouched
    assert torch.equal(got[..., rot:], xt[..., rot:])


def test_rope_pairs_are_interleaved():
    """Feature pairs (0,1), (2,3), ... rotate together, not (i, i+Dh/2)."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0
    c, s = TL.rope_angles(torch.tensor([[1]]), 4)
    y = TL.apply_rope(x, c, s, 4)
    assert y[0, 0, 0, 1] != 0 and y[0, 0, 0, 2] == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    rng = np.random.default_rng(4)
    d, d_ff = 48, 80
    xj, xt = both(rng.normal(size=(2, 6, d)), dtype)
    wij, wit = both(rng.normal(size=(d, 2, d_ff)) / np.sqrt(d), dtype)
    woj, wot = both(rng.normal(size=(d_ff, d)) / np.sqrt(d_ff), dtype)
    want = JL.mlp(xj, {"w_in": wij, "w_out": woj})
    got = TL.mlp(xt, {"w_in": wit, "w_out": wot})
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


def test_param_builder_shapes_and_stds():
    gen = torch.Generator().manual_seed(0)
    pb = TL.ParamBuilder(gen)
    pb.weight("a/w", (256, 4, 8), ("d_model", "heads", "d_head"), stack=3)
    pb.weight("emb", (512, 64), ("vocab", "d_model"), scale=0.02)
    TL.init_norm(pb, "n", "ln", 64, stack=3)
    w = pb.params["a"]["w"]
    assert tuple(w.shape) == (3, 256, 4, 8) and w.dtype == torch.bfloat16
    assert pb.dims["a"]["w"] == ("layers", "d_model", "heads", "d_head")
    assert abs(w.float().std().item() - 1 / 16) < 0.1 / 16
    assert abs(pb.params["emb"].float().std().item() - 0.02) < 0.002
    assert torch.equal(pb.params["n"]["scale"], torch.ones(3, 64))
    assert torch.equal(pb.params["n"]["bias"], torch.zeros(3, 64))
    assert pb.params["n"]["scale"].dtype == torch.float32
