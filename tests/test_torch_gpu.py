"""The port's CUDA kernels on the card, each against its plain version.

Every test here is marked ``gpu`` and skips without a card.  The file
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mlstm_chunk import ops as tml
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
from repro_torch.kernels.rmsnorm import ops as trms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.kernels.ssd_scan.ref import (ssd_scan_kernel_order,
                                              ssd_scan_ref)
from repro_torch.models.lm import LM
from torch_parity import DTYPES, cuda, f32, tol, torch_dtype  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,D", [(8, 576), (4096, 576), (33, 96), (8, 4096),
                                 (4096, 4096), (33, 60), (7, 100)])
def test_rmsnorm_kernel(cuda, dtype, R, D):
    gen = torch.Generator(device=cuda).manual_seed(R)
    x = torch.randn(R, D, generator=gen, device=cuda).to(torch_dtype(dtype))
    s = torch.randn(D, generator=gen, device=cuda) + 1.0
    before = trms.rmsnorm.launches
    got = trms.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert trms.rmsnorm.launches == before + 1
    np.testing.assert_allclose(f32(got), f32(rmsnorm_ref(x, s)),
                               **tol(dtype))


def test_rmsnorm_kernel_scale_and_views(cuda):
    """A bf16 scale with bf16 x (read as it is, no cast), a non-contiguous
    x, a contiguous x 2 bytes off 16-byte alignment (the narrow path), and
    capture in a CUDA graph: one launch per call each time."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(16, 4096 + 1, generator=gen, device=cuda).bfloat16()
    s = (torch.randn(4096, generator=gen, device=cuda) + 1.0).bfloat16()
    flat = x.reshape(-1)[:1 + 16 * 4096]
    for xv in (x[:, :4096], flat[1:].view(16, 4096), x[:, 1:].contiguous()):
        before = trms.rmsnorm.launches
        got = trms.rmsnorm(xv, s)
        torch.cuda.synchronize()
        assert trms.rmsnorm.launches == before + 1
        np.testing.assert_allclose(f32(got), f32(rmsnorm_ref(xv, s)),
                                   **tol("bfloat16"))
    xc = x[:, 1:].contiguous()
    trms.rmsnorm(xc, s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = trms.rmsnorm(xc, s)
    xc.copy_(x[:, :4096])
    g.replay()
    torch.cuda.synchronize()
    np.testing.assert_allclose(f32(out), f32(rmsnorm_ref(xc, s)),
                               **tol("bfloat16"))


def test_rmsnorm_kernel_refuses(cuda):
    with pytest.raises(ValueError, match="scale must be"):
        trms.rmsnorm(torch.ones(2, 12, device=cuda),
                     torch.ones(13, device=cuda))
    with pytest.raises(TypeError, match="bf16 or f32"):
        trms.rmsnorm(torch.ones(2, 16, device=cuda, dtype=torch.float16),
                     torch.ones(16, device=cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,Dh,causal,window", [
    (4, 1024, 1024, 9, 3, 64, True, None),
    (4, 1024, 1024, 9, 3, 64, True, 96),
    (2, 1000, 1000, 3, 3, 64, True, None),
    (2, 128, 256, 4, 4, 32, False, None),
    (1, 300, 300, 8, 2, 128, True, None),
    (1, 77, 77, 3, 1, 16, True, 16),
    (4, 1024, 1024, 32, 8, 128, True, None),   # jamba prefill
    (2, 200, 200, 5, 1, 12, True, None),       # smollm-360m smoke: Dh 12
    (2, 200, 200, 5, 1, 12, True, 16),
    (2, 300, 300, 32, 32, 80, True, None),     # stablelm-3b: Dh 80
    (2, 300, 300, 32, 32, 80, True, 96),
    (1, 333, 333, 32, 8, 120, True, None),     # h2o-danube-3-4b: Dh 120
    (1, 333, 333, 32, 8, 120, True, 96),
    (2, 64, 160, 4, 2, 120, False, None),
])
def test_flash_attention_kernel(cuda, dtype, B, Sq, Skv, H, KVH, Dh, causal,
                                window):
    gen = torch.Generator(device=cuda).manual_seed(Sq + H)
    td = torch_dtype(dtype)
    q = torch.randn(B, Sq, H, Dh, generator=gen, device=cuda).to(td)
    k = torch.randn(B, Skv, KVH, Dh, generator=gen, device=cuda).to(td)
    v = torch.randn(B, Skv, KVH, Dh, generator=gen, device=cuda).to(td)
    qk, kk, vk = tfa.to_kernel_layout(q, k, v)
    before = tfa.flash_attention.launches
    got = tfa.mha(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.from_kernel_layout(
        attention_ref(qk, kk, vk, causal=causal, window=window), B)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("B,S,H,KVH,Dh,window", [
    (4, 1024, 9, 3, 64, None),      # smollm prefill
    (1, 300, 8, 2, 128, None),
    (1, 200, 4, 2, 32, 48),
])
def test_flash_attention_kernel_peaked_softmax(cuda, B, S, H, KVH, Dh,
                                               window):
    """q and k scaled by 8: scores of a few hundred, so each row's
    softmax puts nearly all its weight on a few keys.  The bf16 kernel
    rounds P to bf16 before P·V, where the plain version keeps it in f32;
    held at the unchanged bf16 tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(S + Dh)
    q = (torch.randn(B, S, H, Dh, generator=gen, device=cuda) * 8).bfloat16()
    k = (torch.randn(B, S, KVH, Dh, generator=gen, device=cuda) * 8) \
        .bfloat16()
    v = torch.randn(B, S, KVH, Dh, generator=gen, device=cuda).bfloat16()
    qk, kk, vk = tfa.to_kernel_layout(q, k, v)
    got = tfa.mha(q, k, v, causal=True, window=window)
    want = tfa.from_kernel_layout(
        attention_ref(qk, kk, vk, causal=True, window=window), B)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


def test_flash_attention_kernel_refuses(cuda):
    q = torch.ones(1, 1, 8, 192, device=cuda)
    k = torch.ones(1, 8, 192, device=cuda)
    with pytest.raises(NotImplementedError, match="Dh"):
        tfa.flash_attention(q, k, k[..., :128])
    with pytest.raises(TypeError, match="bf16 or f32"):
        tfa.flash_attention(q[..., :64].half(), k[..., :64].half(),
                            k[..., :64].half())


@pytest.mark.parametrize("arch,smoke,window", [
    ("stablelm-3b", False, None),          # Dh 80, LayerNorm, rope 25%
    ("h2o-danube-3-4b", False, 96),        # Dh 120, sliding window
    ("smollm-360m", True, None),           # Dh 12, d 60
])
def test_prefill_runs_the_kernels_at_any_head_dim(cuda, arch, smoke, window):
    """Two layers at the published widths (the smoke config for
    smollm-360m), kernels against the plain path; the window is cut
    below the prompt so that it masks."""
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), n_layers=2)
    if window is not None:
        cfg = dataclasses.replace(cfg, attn_window=window)
    lm_k = LM(cfg, use_kernels=True, device=cuda)
    lm_p = LM(cfg, use_kernels=False, device=cuda)
    params, _ = lm_k.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 200), device=cuda)
    fa0, rms0 = tfa.flash_attention.launches, trms.rmsnorm.launches
    got = lm_k.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - fa0 == cfg.n_layers
    assert trms.rmsnorm.launches - rms0 == \
        (2 * cfg.n_layers + 1 if cfg.norm == "rms" else 0)
    want = lm_p.prefill(params, {"tokens": toks})
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(f32(got), f32(want), atol=0.25, rtol=0.1)


@pytest.fixture
def smoke_lm(cuda):
    cfg = get_config("smollm-135m", smoke=True)
    lm = LM(cfg, use_kernels=True, device=cuda)
    params, _ = lm.init(0)
    return lm, params


def test_prefill_runs_the_kernels(cuda, smoke_lm):
    lm_k, params = smoke_lm
    cfg = lm_k.cfg
    lm_p = LM(cfg, use_kernels=False, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    fa0, rms0 = tfa.flash_attention.launches, trms.rmsnorm.launches
    got = lm_k.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches - fa0 == cfg.n_layers
    assert trms.rmsnorm.launches - rms0 == 2 * cfg.n_layers + 1
    want = lm_p.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(got), f32(want), atol=0.25, rtol=0.1)


#: the reference's tolerance for the mLSTM kernel (``test_kernels.py``)
MLSTM_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Dh,chunk", [
    (4, 1024, 4, 384, 256),    # xlstm-125m prefill
    (2, 32, 4, 32, 16),        # xlstm smoke
    (2, 48, 1, 8, 48),
    (1, 200, 3, 48, 200),      # ragged last chunk, Dh not a tile multiple
    (2, 100, 2, 64, 100),      # ragged last chunk of 36 steps
    (1, 70, 2, 6, 70),         # rows of 6 elements: padded in a copy
])
def test_mlstm_chunk_kernel(cuda, dtype, B, S, H, Dh, chunk):
    gen = torch.Generator(device=cuda).manual_seed(S + Dh)
    td = torch_dtype(dtype)

    def rnd(*shape, shift=0.0):
        return (torch.randn(shape, generator=gen, device=cuda)
                + shift).to(td)
    q, k, v = (rnd(B, S, H, Dh) for _ in range(3))
    i_pre, f_pre = rnd(B, S, H), rnd(B, S, H, shift=2.0)
    before = tml.mlstm_chunk.launches
    got = tml.mlstm_chunk(q, k, v, i_pre, f_pre, chunk=chunk)
    torch.cuda.synchronize()
    assert tml.mlstm_chunk.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, H * Dh)
    want = tml.mlstm_chunk_plain(q, k, v, i_pre, f_pre, chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), **MLSTM_TOL)


def test_mlstm_chunk_kernel_reads_strided_views(cuda):
    """q/k/v as views of one qkv projection and i/f as views of one gate
    projection, as ``mlstm_block`` hands them over."""
    B, S, H, Dh = 2, 64, 2, 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(B, S, 3, H * Dh, generator=gen, device=cuda)
    gates = torch.randn(B, S, 2, H, generator=gen, device=cuda)
    q, k, v = (qkv[:, :, i].reshape(B, S, H, Dh) for i in range(3))
    got = tml.mlstm_chunk(q, k, v, gates[:, :, 0], gates[:, :, 1], chunk=16)
    want = tml.mlstm_chunk_plain(q, k, v, gates[:, :, 0], gates[:, :, 1],
                                 chunk=16)
    np.testing.assert_allclose(f32(got), f32(want), **MLSTM_TOL)


def test_mlstm_chunk_kernel_refuses(cuda):
    x = torch.ones(1, 16, 2, 8, device=cuda)
    g = torch.ones(1, 16, 2, device=cuda)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tml.mlstm_chunk(x.half(), x.half(), x.half(), g.half(), g.half())
    with pytest.raises(TypeError, match="one dtype"):
        tml.mlstm_chunk(x, x, x, g.bfloat16(), g)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tml.mlstm_chunk(x[:, :12], x[:, :12], x[:, :12], g[:, :12],
                        g[:, :12], chunk=8)


def test_xlstm_prefill_runs_the_kernels(cuda):
    cfg = get_config("xlstm-125m", smoke=True)
    lm_k = LM(cfg, use_kernels=True, device=cuda)
    lm_p = LM(cfg, use_kernels=False, device=cuda)
    params, _ = lm_k.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 48), device=cuda)
    ml0, rms0 = tml.mlstm_chunk.launches, trms.rmsnorm.launches
    got = lm_k.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    n_m = sum(m == "mlstm" for m, _ in cfg.layer_kinds())
    assert tml.mlstm_chunk.launches - ml0 == n_m
    assert trms.rmsnorm.launches - rms0 == cfg.n_layers + 1
    want = lm_p.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(got), f32(want), atol=0.25, rtol=0.1)


#: the reference's tolerance for the selective scan (``test_kernels.py``)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
# against the kernel-order mirror: just above what ex2.approx against
# torch.exp2 (2 ulp a step) can reach through h over a few hundred steps
SSD_ORDER_TOL = dict(rtol=1e-5, atol=1e-5)


def _ssd_inputs(gen, B, S, Din, N, x_dtype, dev, dt_range=(0.01, 0.2),
                a_range=(0.5, 2.0)):
    """dt uniform in ``dt_range``, -A in ``a_range``."""
    x = torch.randn(B, S, Din, generator=gen, device=dev).to(x_dtype)
    lo, hi = dt_range
    dt = torch.rand(B, S, Din, generator=gen, device=dev) * (hi - lo) + lo
    lo, hi = a_range
    A = -(torch.rand(Din, N, generator=gen, device=dev) * (hi - lo) + lo)
    Bm = torch.randn(B, S, N, generator=gen, device=dev)
    Cm = torch.randn(B, S, N, generator=gen, device=dev)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,Din,N,chunk", [
    (4, 1024, 8192, 16, 256),  # jamba prefill
    (2, 64, 16, 4, 16),        # the reference's kernel test shapes
    (1, 128, 32, 8, 32),
    (2, 96, 24, 16, 48),
    (3, 77, 200, 8, 77),       # ragged: Din not a multiple of a block
])
def test_ssd_scan_kernel(cuda, x_dtype, B, S, Din, N, chunk):
    gen = torch.Generator(device=cuda).manual_seed(S + Din)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, S, Din, N, torch_dtype(x_dtype),
                                   cuda)
    before = tssd.ssd_scan.launches
    got = tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, d_block=Din)
    torch.cuda.synchronize()
    assert tssd.ssd_scan.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, Din)
    np.testing.assert_allclose(f32(got), f32(ssd_scan_ref(x, dt, A, Bm, Cm)),
                               **SSD_TOL)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S,Din,N,dt_range,a_range", [
    # exp(dt·A) close to 1
    (2, 256, 1024, 16, (1e-4, 1e-3), (0.5, 2.0)),
    # dt·A·log2(e) below -126 (the exponential underflows) for about half
    # of the states, above it for the rest
    (2, 96, 256, 16, (0.5, 2.0), (1.0, 200.0)),
    # N = 4 and 8: a lane holds all of them
    (2, 256, 1024, 4, (0.01, 0.2), (0.5, 2.0)),
    (2, 256, 1024, 8, (0.01, 0.2), (0.5, 2.0)),
    # Din: one 128-channel block and 8 channels of the next
    (3, 50, 136, 16, (0.01, 0.2), (0.5, 2.0)),
    # one warp, 8 of its lanes live
    (1, 33, 8, 8, (1e-4, 1e-3), (0.5, 2.0)),
])
def test_ssd_scan_kernel_edges(cuda, x_dtype, B, S, Din, N, dt_range,
                               a_range):
    """Against the plain recurrence at the reference's 1e-4, and against
    its kernel-order mirror (software exponential on the same states) at
    1e-5, which pins the kernel's order and arithmetic."""
    gen = torch.Generator(device=cuda).manual_seed(B * S + Din + N)
    t = _ssd_inputs(gen, B, S, Din, N, torch_dtype(x_dtype), cuda, dt_range,
                    a_range)
    got = tssd.ssd_scan(*t, chunk=S, d_block=Din)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(f32(got), f32(ssd_scan_ref(*t)), **SSD_TOL)
    np.testing.assert_allclose(f32(got), f32(ssd_scan_kernel_order(*t)),
                               **SSD_ORDER_TOL)


def test_ssd_scan_kernel_reads_strided_views(cuda):
    """x and dt as views of wider tensors and B, C as bf16 views of one
    projection, as ``mamba_block`` hands them over."""
    B, S, Din, N = 2, 64, 96, 16
    gen = torch.Generator(device=cuda).manual_seed(5)
    xz = torch.randn(B, S, 2 * Din, generator=gen, device=cuda).bfloat16()
    dt2 = torch.rand(B, S, 2 * Din, generator=gen, device=cuda) * 0.2
    A = -(torch.rand(Din, N, generator=gen, device=cuda) + 0.5)
    proj = torch.randn(B, S, 8 + 2 * N, generator=gen, device=cuda).bfloat16()
    x, dt = xz[..., :Din], dt2[..., Din:]
    Bm, Cm = proj[..., 8:8 + N], proj[..., 8 + N:]
    got = tssd.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    want = ssd_scan_ref(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(f32(got), f32(want), **SSD_TOL)
    # a view the kernel cannot stream 16 bytes at a time is copied
    x1 = xz[..., 1:Din + 1]
    got = tssd.ssd_scan(x1, dt, A, Bm, Cm, chunk=16)
    np.testing.assert_allclose(f32(got), f32(ssd_scan_ref(x1, dt, A, Bm,
                                                          Cm)), **SSD_TOL)


def test_ssd_scan_kernel_refuses(cuda):
    x = torch.ones(1, 16, 8, device=cuda)
    A = -torch.ones(8, 4, device=cuda)
    Bm = torch.ones(1, 16, 4, device=cuda)
    with pytest.raises(TypeError, match="bf16 or f32"):
        tssd.ssd_scan(x.half(), x, A, Bm, Bm)
    with pytest.raises(NotImplementedError, match="N in"):
        tssd.ssd_scan(x, x, -torch.ones(8, 5, device=cuda),
                      torch.ones(1, 16, 5, device=cuda),
                      torch.ones(1, 16, 5, device=cuda))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssd.ssd_scan(x[:, :12], x[:, :12], A, Bm[:, :12], Bm[:, :12],
                      chunk=8)
    with pytest.raises(NotImplementedError, match="Din % 8"):
        tssd.ssd_scan(x[..., :6], x[..., :6], A[:6], Bm, Bm)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,C,D,F", [
    (16, 8, 4096, 28672),      # jamba decode, first product
    (16, 1, 14336, 4096),      # one row: decode_offline, second product
    (4, 16, 128, 64),          # the most rows the 16-row tile takes
    (4, 17, 128, 64),          # the fewest the 128-row tile takes
    (16, 640, 14336, 4096),    # jamba prefill, second product
    (4, 32, 64, 128),          # the reference's kernel test shapes
    (8, 64, 32, 64),
    (3, 100, 40, 24),          # ragged: no dimension a tile multiple
])
def test_moe_gmm_kernel(cuda, dtype, E, C, D, F):
    gen = torch.Generator(device=cuda).manual_seed(C + D)
    td = torch_dtype(dtype)
    x = torch.randn(E, C, D, generator=gen, device=cuda).to(td)
    w = (torch.randn(E, D, F, generator=gen, device=cuda) * 0.1).to(td)
    gs = torch.randint(0, C + 1, (E,), generator=gen, device=cuda,
                       dtype=torch.int32)
    gs[0], gs[-1] = 0, C                    # an empty and a full expert
    before = tgmm.moe_gmm.launches
    got = tgmm.moe_gmm(x, w, gs, c_block=C, f_block=F, d_block=D)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm.launches == before + 1
    assert got.dtype == td and tuple(got.shape) == (E, C, F)
    want = moe_gmm_ref(x, w, gs)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    assert not f32(got[0]).any()


@pytest.mark.parametrize("rows", ["full", "jamba"])
def test_moe_gmm_kernel_prefill_group_sizes(cuda, rows):
    """jamba's first prefill product with every expert full, and with
    512 ± 128 rows each as its router gives at B=4, S=1024."""
    E, C, D, F = 16, 640, 4096, 28672
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(E, C, D, generator=gen, device=cuda).bfloat16()
    w = (torch.randn(E, D, F, generator=gen, device=cuda) * D ** -0.5) \
        .bfloat16()
    if rows == "full":
        gs = torch.full((E,), C, device=cuda, dtype=torch.int32)
    else:
        gs = torch.randint(384, 641, (E,), generator=gen, device=cuda,
                           dtype=torch.int32)
    before = tgmm.moe_gmm.launches
    got = tgmm.moe_gmm(x, w, gs, c_block=C, f_block=F, d_block=D)
    torch.cuda.synchronize()
    assert tgmm.moe_gmm.launches == before + 1
    want = moe_gmm_ref(x, w, gs)
    # on the card: 293 M outputs (assert_close's test is assert_allclose's)
    torch.testing.assert_close(got.float(), want.float(), **tol("bfloat16"))


def test_moe_gmm_kernel_copies_strided_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(4, 64, 32, generator=gen, device=cuda).bfloat16()
    w = torch.randn(4, 32, 64, generator=gen, device=cuda).bfloat16()
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)   # same values
    wv = w[:, :, :32]                                     # a strided view
    gs = torch.tensor([64, 0, 17, 40], device=cuda, dtype=torch.int32)
    got = tgmm.moe_gmm(xt, wv, gs, c_block=64, f_block=32, d_block=32)
    np.testing.assert_allclose(f32(got), f32(moe_gmm_ref(x, wv, gs)),
                               **tol("bfloat16"))


def test_moe_gmm_kernel_refuses(cuda):
    x = torch.ones(2, 8, 16, device=cuda)
    w = torch.ones(2, 16, 8, device=cuda)
    gs = torch.full((2,), 8, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError, match="one dtype"):
        tgmm.moe_gmm(x, w.bfloat16(), gs)
    with pytest.raises(TypeError, match="one dtype"):
        tgmm.moe_gmm(x.half(), w.half(), gs)
    with pytest.raises(ValueError, match="multiples of 8"):
        tgmm.moe_gmm(x[..., :12], w[:, :12], gs)


def test_jamba_prefill_runs_the_kernels(cuda):
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True),
                              n_layers=16)
    lm_k = LM(cfg, use_kernels=True, device=cuda)
    lm_p = LM(cfg, use_kernels=False, device=cuda)
    params, _ = lm_k.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 48), device=cuda)
    counts = (trms.rmsnorm, tfa.flash_attention, tssd.ssd_scan,
              tgmm.moe_gmm)
    before = [f.launches for f in counts]
    got = lm_k.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counts, before)] == [33, 2, 14, 16]
    want = lm_p.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(f32(got), f32(want), atol=0.25, rtol=0.1)


# -- CUDA graphs of the serving steps (``launch/graphs.py``) ---------------

def _smoke(arch, cuda, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    lm = LM(cfg, use_kernels=True, device=cuda)
    params, _ = lm.init(0)
    return lm, params


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tree_leaves(v)
    elif tree is not None:
        yield tree


@pytest.mark.parametrize("arch,vector_pos", [("smollm-135m", True),
                                             ("xlstm-125m", True),
                                             ("jamba-v0.1-52b", False)])
def test_step_graph_replay_matches_eager_step(cuda, arch, vector_pos):
    """Replays of a captured ``StepGraph`` against the eager
    ``decode_step`` on the same inputs: logits and every cache leaf at
    the bf16 tolerance (cuBLAS may pick other algorithms under capture),
    the slot held inactive bit-identical."""
    from repro_torch.launch import graphs
    lm, params = _smoke(arch, cuda)
    B, S_max = 3, 32
    g = graphs.StepGraph(lm, params, B, S_max, vector_pos)
    assert g.graph is not None
    caches = lm.init_caches(B, S_max, vector_pos=vector_pos)
    gen = torch.Generator(device=cuda).manual_seed(0)
    active = torch.tensor([True, False, True], device=cuda)
    pos = torch.tensor([2, 5, 0], dtype=torch.int32, device=cuda)
    for t in range(6):
        toks = torch.randint(0, lm.cfg.vocab, (B, 1), generator=gen,
                             device=cuda)
        if vector_pos:
            got = g.run(toks, pos + t, active).clone()
            want, caches = lm.decode_step(params, {
                "tokens": toks, "pos": pos + t, "active": active}, caches)
        else:
            got = g.run(toks, t).clone()
            want, caches = lm.decode_step(params, {
                "tokens": toks, "pos": torch.tensor(t, dtype=torch.int32,
                                                    device=cuda)}, caches)
        np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    for gi, (_pattern, repeats) in enumerate(lm._groups()):
        grp = f"group{gi}"
        for a, b in zip(_tree_leaves(g.caches[grp]),
                        _tree_leaves(caches[grp])):
            np.testing.assert_allclose(f32(a), f32(b), **tol("bfloat16"))
            if vector_pos:      # slot 1 never stepped: still zero
                assert not a.select(1 if repeats > 1 else 0, 1).any()
    graphs.release()


def test_step_graph_counts_replayed_launches(cuda):
    """The capture adds no launch (the warm-up's one step ran), and N
    replays add N times a step's: every norm and two grouped matmuls per
    MoE layer."""
    from repro_torch.launch import graphs
    lm, params = _smoke("jamba-v0.1-52b", cuda)
    kinds = lm.cfg.layer_kinds()
    per_step = [lm.cfg.n_layers + 1 + sum(f != "none" for _, f in kinds),
                2 * sum(f == "moe" for _, f in kinds)]
    counted = (trms.rmsnorm, tgmm.moe_gmm)
    before = [f.launches for f in counted]
    g = graphs.StepGraph(lm, params, 2, 16, False)
    assert [f.launches - b for f, b in zip(counted, before)] == per_step
    before = [f.launches for f in counted]
    toks = torch.zeros((2, 1), dtype=torch.int64, device=cuda)
    for t in range(5):
        g.run(toks, t)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == \
        [5 * n for n in per_step]
    graphs.release()


def test_capture_refuses_host_syncs_and_replaced_routers(cuda, monkeypatch):
    """A step that reads a value on the host raises at capture, with the
    counters as they were; so does an MoE model's step while
    ``router_topk`` is replaced (a replay would reuse the capture's
    routing).  Nothing falls back to the eager step."""
    from repro_torch.launch import graphs
    from repro_torch.models import moe
    x = torch.ones(4, device=cuda)
    before = trms.rmsnorm.launches
    scale = torch.ones(4, device=cuda)

    def synced():
        trms.rmsnorm(x[None], scale)
        if x.sum().item() > 0:
            x.add_(1)
    with pytest.raises(RuntimeError):
        graphs.Graph(synced, lambda: None, cuda)
    assert trms.rmsnorm.launches == before
    lm, params = _smoke("jamba-v0.1-52b", cuda)
    monkeypatch.setattr(moe, "router_topk",
                        lambda *a: moe.ROUTER_TOPK(*a))
    with pytest.raises(RuntimeError, match="router_topk is replaced"):
        graphs.step_graph(lm, params, 2, 16, False)
    graphs.release()


def test_slstm_graph_matches_the_loop(cuda):
    """xLSTM prefill with the sLSTM recurrence replayed from its CUDA
    graph against the host loop (``graphs=False``): twice, so the second
    prefill replays the memoised graphs."""
    from repro_torch.launch import graphs
    lm, params = _smoke("xlstm-125m", cuda)
    loop = dataclasses.replace(lm, graphs=False)
    n0 = graphs.stats()["graphs"]
    for seed in (0, 1):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        toks = torch.randint(0, lm.cfg.vocab, (2, 48), generator=gen,
                             device=cuda)
        got = lm.prefill(params, {"tokens": toks})
        want = loop.prefill(params, {"tokens": toks})
        np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    n_s = sum(m == "slstm" for m, _ in lm.cfg.layer_kinds())
    assert graphs.stats()["graphs"] - n0 == n_s
    # a graph carries no gradients: asked for some, it refuses
    from repro_torch.models import xlstm
    mix = params["group1"]["b0"]["mix"]                # the sLSTM layer
    assert "r_gates" in mix
    p = {k: v.detach().requires_grad_() for k, v in mix.items()}
    x = torch.randn(2, 8, lm.cfg.d_model, device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="no gradients"):
        xlstm._scan_graph(p, x)
    graphs.release()


# -- the train step --------------------------------------------------------

def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step on the card against one on the CPU, from the same
    params and batch: loss within 1e-3 and the global gradient norm
    within 1e-2 relative; every updated param within the most one AdamW
    step can move it either way, 2·lr·(1 + wd·|p|), plus one bf16 step of
    |p|."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_config(arch, smoke=True)
    batch = SyntheticCorpus(cfg.vocab, seed=0).batch(0, 0, 2, 32)
    params, _ = LM(cfg, device="cpu").init(0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        step = build_train_step(cfg, device=dev)
        p = _tree_to(params, dev)
        grads, metrics = step.grads(p, batch)
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in tree_leaves(grads))).item()
        p, _, _ = step.fn(p, step.opt.init(p), batch)
        out[dev.type] = (float(metrics["loss"]), gn, _tree_to(p, "cpu"))
    (lc, gc, pc), (lh, gh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-3 * abs(lh)
    assert abs(gc - gh) <= 1e-2 * gh
    opt = step.opt
    for a, b, w0 in zip(tree_leaves(pc), tree_leaves(ph),
                        tree_leaves(params)):
        w0 = w0.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            w0.abs().clamp_min(1e-30))) - 7)
        bound = 2 * opt.lr * (1 + opt.weight_decay * w0.abs()) + ulp
        assert bool(((a.float() - b.float()).abs() <= bound).all())


def test_kernel_wrappers_refuse_gradients_on_card(cuda):
    """Each kernel wrapper raises on a CUDA input that requires grad (its
    output would carry none), before it launches anything."""
    gen = torch.Generator(device=cuda).manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)
    calls = [
        (trms.rmsnorm, [r(8, 64), r(64, dtype=torch.float32)], {}),
        (tfa.flash_attention, [r(2, 2, 64, 64), r(2, 64, 64),
                               r(2, 64, 64)], {}),
        (tfa.mha, [r(1, 64, 4, 64), r(1, 64, 2, 64), r(1, 64, 2, 64)], {}),
        (tml.mlstm_chunk, [r(1, 64, 2, 64), r(1, 64, 2, 64),
                           r(1, 64, 2, 64), r(1, 64, 2), r(1, 64, 2)],
         {"chunk": 64}),
        (tssd.ssd_scan, [r(1, 64, 64), r(1, 64, 64).abs(),
                         -r(64, 8, dtype=torch.float32).abs(), r(1, 64, 8),
                         r(1, 64, 8)], {"chunk": 64}),
        (tgmm.moe_gmm, [r(2, 16, 64), r(2, 64, 64)], {}),
    ]
    for fn, xs, kw in calls:
        extra = ([torch.tensor([3, 16], dtype=torch.int32, device=cuda)]
                 if fn is tgmm.moe_gmm else [])
        for i in range(len(xs)):
            ys = [x.clone().requires_grad_(j == i) for j, x in enumerate(xs)]
            before = [f.launches for f in (trms.rmsnorm, tfa.flash_attention,
                                           tml.mlstm_chunk, tssd.ssd_scan,
                                           tgmm.moe_gmm)]
            with pytest.raises(RuntimeError, match="carry no gradient"):
                fn(*ys, *extra, **kw)
            assert before == [f.launches for f in (
                trms.rmsnorm, tfa.flash_attention, tml.mlstm_chunk,
                tssd.ssd_scan, tgmm.moe_gmm)]
            with torch.no_grad():
                fn(*ys, *extra, **kw)
    torch.cuda.synchronize()


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_from_card_restores_on_cpu(cuda, tmp_path):
    """A params-and-AdamW tree saved from the card (in the background)
    restores on the CPU, and back onto the card, bit for bit."""
    from repro_torch.distributed import CheckpointManager
    from repro_torch.distributed.checkpoint import _flatten, _unflatten
    from repro_torch.optim import AdamW
    params, _ = LM(get_config("smollm-135m", smoke=True),
                   device=cuda).init(0)
    opt = AdamW()
    state = opt.init(params)
    opt.update(_unflatten(params, [torch.randn_like(v, dtype=torch.float32)
                                   for _, v in _flatten(params)]),
               state, params)
    tree = {"params": params, "opt": state}
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree)
    mgr.wait()
    named = _flatten(tree)
    for device in ("cpu", cuda):
        like = _unflatten(tree, [torch.zeros_like(v, device=device)
                                 for _, v in named])
        got = _flatten(mgr.restore(3, like))
        for (k, a), (_, b) in zip(named, got):
            assert b.device.type == torch.device(device).type, k
            a, b = a.cpu(), b.cpu()
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), k
