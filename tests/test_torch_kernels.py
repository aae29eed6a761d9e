"""The port's kernel wrappers against the reference's Pallas kernels.

On the CPU a wrapper computes its kernel's plain version; the Pallas
kernels run in interpret mode, as ``test_kernels.py`` runs them.  The CUDA
kernels themselves are held to their plain versions on the card by
``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention.ref import attention_ref as j_attention
from repro.kernels.mlstm_chunk import kernel as jmlk
from repro.kernels.mlstm_chunk import ops as jml
from repro.kernels.rmsnorm import ops as jrms
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.mlstm_chunk import ops as tml
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_ref,
                                                  mlstm_chunk_two_pass)
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.kernels.rmsnorm import ops as trms
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.models.xlstm import _mlstm_parallel
from torch_parity import DTYPES, both, f32, tol

# -- rmsnorm --------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,D,rb", [(64, 128, 16), (32, 96, 32)])
def test_rmsnorm_matches_pallas(dtype, R, D, rb):
    rng = np.random.default_rng(R + D)
    xj, xt = both(rng.normal(size=(R, D)), dtype)
    sj, st = both(rng.normal(size=(D,)) + 1.0, "float32")
    want = jrms.rmsnorm(xj, sj, row_block=rb)
    got = trms.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_flattens_leading_dims(dtype):
    rng = np.random.default_rng(7)
    xj, xt = both(rng.normal(size=(2, 3, 5, 64)), dtype)
    sj, st = both(rng.normal(size=(64,)) + 1.0, "float32")
    want = jrms.rmsnorm(xj, sj)
    got = trms.rmsnorm(xt, st)
    assert got.shape == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [60, 100])
def test_rmsnorm_matches_pallas_any_width(dtype, D):
    """Widths that fill no 16-byte chunk (the kernel's narrow path)."""
    rng = np.random.default_rng(D)
    xj, xt = both(rng.normal(size=(32, D)), dtype)
    sj, st = both(rng.normal(size=(D,)) + 1.0, "float32")
    want = jrms.rmsnorm(xj, sj, row_block=16)
    got = trms.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


# -- flash attention ---------------------------------------------------------


def _mha_inputs(rng, B, Sq, Skv, H, KVH, Dh, dtype):
    q = rng.normal(size=(B, Sq, H, Dh))
    k = rng.normal(size=(B, Skv, KVH, Dh))
    v = rng.normal(size=(B, Skv, KVH, Dh))
    return [both(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KVH,Dh,causal,window,qb,kb", [
    (2, 128, 128, 4, 2, 32, True, None, 64, 64),
    (1, 256, 256, 3, 1, 16, True, 96, 64, 128),
    (2, 128, 256, 4, 4, 64, False, None, 128, 128),
    (1, 512, 512, 8, 2, 128, True, None, 128, 256),
])
def test_mha_matches_pallas(dtype, B, Sq, Skv, H, KVH, Dh, causal, window,
                            qb, kb):
    rng = np.random.default_rng(Sq + H)
    (qj, qt), (kj, kt), (vj, vt) = _mha_inputs(rng, B, Sq, Skv, H, KVH, Dh,
                                               dtype)
    want = jfa.mha(qj, kj, vj, causal=causal, window=window, q_block=qb,
                   kv_block=kb)
    got = tfa.mha(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, Sq, H, Dh)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (100, 100, True, None),
    (77, 77, True, 16),
    (50, 70, False, None),
])
def test_mha_ragged_lengths(dtype, Sq, Skv, causal, window):
    """Lengths that no block size divides: the Pallas kernel asserts
    divisibility, so the plain oracle stands in for it."""
    rng = np.random.default_rng(Sq * Skv)
    B, H, KVH, Dh = 2, 6, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _mha_inputs(rng, B, Sq, Skv, H, KVH, Dh,
                                               dtype)
    qk, kk, vk = tfa.to_kernel_layout(qt, kt, vt)
    want = j_attention(*(jnp.asarray(f32(t), getattr(jnp, dtype))
                         for t in (qk, kk, vk)), causal=causal,
                       window=window)
    got = tfa.flash_attention(qk, kk, vk, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    back = tfa.mha(qt, kt, vt, causal=causal, window=window)
    assert torch.equal(back, tfa.from_kernel_layout(got, B))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("Dh", [12, 80, 120])
def test_mha_matches_pallas_head_dims(dtype, Dh, window):
    """The head dims of smollm-360m's smoke model (12), stablelm-3b (80)
    and h2o-danube-3-4b (120, which slides a window)."""
    rng = np.random.default_rng(Dh + (window or 0))
    B, S, H, KVH = 1, 64, 4, 2
    (qj, qt), (kj, kt), (vj, vt) = _mha_inputs(rng, B, S, S, H, KVH, Dh,
                                               dtype)
    want = jfa.mha(qj, kj, vj, causal=True, window=window, q_block=32,
                   kv_block=32)
    got = tfa.mha(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, S, H, Dh)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("dh,elt,row,width", [
    (12, 2, 16, 16),       # smollm-360m smoke, bf16: 24-byte rows padded
    (12, 4, 12, 16),       # f32: 48-byte rows, zero-filled to 16
    (16, 2, 16, 16),
    (40, 2, 40, 64),
    (64, 2, 64, 64),
    (80, 2, 80, 80),       # stablelm-3b: a width of its own
    (96, 4, 96, 128),
    (120, 2, 120, 128),    # h2o-danube-3-4b
    (127, 2, 128, 128),
    (128, 4, 128, 128),
])
def test_flash_kernel_dims(dh, elt, row, width):
    assert tfa.kernel_dims(dh, dh, elt) == (row, width)
    assert width in tfa.WIDTHS and row % (16 // elt) == 0


@pytest.mark.parametrize("dh,dv", [(192, 128), (136, 136), (64, 32),
                                   (0, 0)])
def test_flash_kernel_dims_refuses(dh, dv):
    with pytest.raises(NotImplementedError, match="Dh"):
        tfa.kernel_dims(dh, dv, 2)


def test_layout_round_trip():
    q = torch.randn(2, 9, 6, 16)
    k = torch.randn(2, 9, 2, 16)
    qk, kk, vk = tfa.to_kernel_layout(q, k, k)
    assert tuple(qk.shape) == (4, 3, 9, 16) and tuple(kk.shape) == (4, 9, 16)
    # head h = kvh * G + g, as the reference's reshape groups it
    assert torch.equal(qk[1 * 2 + 1, 2], q[1, :, 1 * 3 + 2])
    assert torch.equal(tfa.from_kernel_layout(qk, 2), q)


# -- mlstm chunk ----------------------------------------------------------------

#: the reference's tolerance for this kernel (``test_kernels.py``)
MLSTM_TOL = dict(rtol=2e-3, atol=2e-3)


def _mlstm_inputs(rng, B, S, H, Dh, dtype="float32"):
    shape = (B, S, H, Dh)
    arrs = [rng.normal(size=shape) for _ in range(3)] + [
        rng.normal(size=shape[:3]), rng.normal(size=shape[:3]) + 2.0]
    return [both(a, dtype) for a in arrs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Dh,chunk", [
    (2, 32, 2, 16, 8),
    (1, 64, 4, 32, 16),
    (2, 48, 1, 8, 48),     # single chunk == full parallel form
    (2, 32, 4, 32, 16),    # the xlstm smoke model's mLSTM
])
def test_mlstm_chunk_matches_pallas(dtype, B, S, H, Dh, chunk):
    rng = np.random.default_rng(S * H + Dh)
    j, t = zip(*_mlstm_inputs(rng, B, S, H, Dh, dtype))
    want = jml.mlstm_chunk(*j, chunk=chunk)
    got = tml.mlstm_chunk(*t, chunk=chunk)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, S, H * Dh)
    np.testing.assert_allclose(f32(got), f32(want), **MLSTM_TOL)


def _two_pass_model_layout(t, chunk):
    B, S, H, Dh = t[0].shape
    y = mlstm_chunk_two_pass(*tml.to_kernel_layout(*t), chunk=chunk)
    return y.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Dh,chunk", [
    (2, 32, 2, 16, 8),
    (1, 64, 4, 32, 16),
    (2, 48, 1, 8, 48),
    (2, 32, 4, 32, 16),
])
def test_mlstm_two_pass_matches_pallas(dtype, B, S, H, Dh, chunk):
    """The CUDA kernel's two-pass blocking, at its own chunk, against the
    Pallas kernel at the model's, in the kernel layout."""
    rng = np.random.default_rng(S * H + Dh)
    j, t = zip(*_mlstm_inputs(rng, B, S, H, Dh, dtype))
    want = jmlk.mlstm_chunk(*(jnp.asarray(f32(x), getattr(jnp, dtype))
                              for x in tml.to_kernel_layout(*t)),
                            chunk=chunk)
    got = mlstm_chunk_two_pass(*tml.to_kernel_layout(*t),
                               chunk=tml.KERNEL_CHUNK)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B * H, S, Dh)
    np.testing.assert_allclose(f32(got), f32(want), **MLSTM_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_two_pass_chunks_match_pallas(chunk):
    rng = np.random.default_rng(13)
    B, S, H, Dh = 2, 64, 3, 16
    j, t = zip(*_mlstm_inputs(rng, B, S, H, Dh))
    want = jml.mlstm_chunk(*j, chunk=chunk)
    got = _two_pass_model_layout(t, chunk)
    np.testing.assert_allclose(f32(got), f32(want), **MLSTM_TOL)


@pytest.mark.parametrize("S,chunk", [(40, 16), (70, 64)])
def test_mlstm_two_pass_ragged_last_chunk(S, chunk):
    """A last chunk shorter than the rest, as the CUDA kernel meets when
    S is no multiple of its chunk; the Pallas kernel runs one that
    divides S."""
    rng = np.random.default_rng(S)
    B, H, Dh = 1, 2, 8
    j, t = zip(*_mlstm_inputs(rng, B, S, H, Dh))
    want = jml.mlstm_chunk(*j, chunk=S // 2 if S % 2 == 0 else S)
    got = _two_pass_model_layout(t, chunk)
    np.testing.assert_allclose(f32(got), f32(want), **MLSTM_TOL)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunk_does_not_depend_on_the_chunk(chunk):
    """m is the exact running max in every chunking, so each chunk length
    gives the parallel form's output; the CUDA kernel relies on this to
    use its own chunk length."""
    rng = np.random.default_rng(11)
    B, S, H, Dh = 2, 64, 3, 16
    _, t = zip(*_mlstm_inputs(rng, B, S, H, Dh))
    want = _mlstm_parallel(*t).reshape(B, S, H * Dh)
    got = tml.mlstm_chunk(*t, chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


def test_mlstm_chunk_layout_and_ragged_refusal():
    rng = np.random.default_rng(12)
    B, S, H, Dh = 2, 24, 3, 8
    _, t = zip(*_mlstm_inputs(rng, B, S, H, Dh))
    qk, kk, vk, ik, fk = tml.to_kernel_layout(*t)
    assert tuple(qk.shape) == (B * H, S, Dh) and tuple(ik.shape) == (B * H, S)
    # row b*H + h of the kernel layout is head h of batch b
    assert torch.equal(qk[1 * H + 2], t[0][1, :, 2])
    assert torch.equal(fk[1 * H + 2], t[4][1, :, 2])
    y = mlstm_chunk_ref(qk, kk, vk, ik, fk, chunk=8)
    got = tml.mlstm_chunk(*t, chunk=8)
    assert torch.equal(got.reshape(B, S, H, Dh)[1, :, 2], y[1 * H + 2])
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tml.mlstm_chunk(*t, chunk=16)


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        trms.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty(2, 3, 8, 16, device="meta")
    k = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention(q, k, k)
    g = torch.empty(2, 8, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        tml.mlstm_chunk(q, q, q, g, g, chunk=8)


def test_cpu_path_launches_nothing():
    counted = (trms.rmsnorm, tfa.flash_attention, tml.mlstm_chunk,
               tssd.ssd_scan, tgmm.moe_gmm)
    before = [f.launches for f in counted]
    trms.rmsnorm(torch.randn(3, 16), torch.ones(16))
    tfa.mha(torch.randn(1, 8, 2, 16), torch.randn(1, 8, 1, 16),
            torch.randn(1, 8, 1, 16))
    x, g = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2)
    tml.mlstm_chunk(x, x, x, g, g, chunk=8)
    xs, bc = torch.randn(1, 8, 16), torch.randn(1, 8, 4)
    tssd.ssd_scan(xs, xs.abs(), -torch.ones(16, 4), bc, bc, chunk=8)
    tgmm.moe_gmm(torch.randn(2, 8, 16), torch.randn(2, 16, 8),
                 torch.tensor([8, 3]))
    assert [f.launches for f in counted] == before


def test_entry_binds_once_and_raises_on_error(monkeypatch):
    """The launch path: argument types from the signature, set once when
    the entry is first called; a non-zero return raises.  libc's ``abs``
    stands in for a kernel's C entry (it returns its argument's size)."""
    import ctypes
    loads = []

    def load(name):
        loads.append(name)
        return ctypes.CDLL(None)
    monkeypatch.setattr(_build, "load", load)
    entry = _build.Entry("libc", "abs", "i")
    entry(0)
    entry(0)
    assert loads == ["libc"]
    assert entry.fn.argtypes == [ctypes.c_int]
    with pytest.raises(RuntimeError, match="abs: CUDA launch failed with "
                                           "cudaError 7"):
        entry(-7)
    # pointers and 64-bit ints pass whole; ints and floats as C's
    assert [ctypes.sizeof(_build._ARGTYPES[k]) for k in "piqf"] == \
        [8, 4, 8, 4]
    assert _build._ARGTYPES["f"] is ctypes.c_float


def test_build_sources_and_flags():
    assert _build.sources() == ["flash_attention", "mlstm_chunk", "moe_gmm",
                                "rmsnorm", "ssd_scan"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    # the library name carries a hash of its sources and flags
    assert _build._lib_path("rmsnorm") != _build._lib_path("flash_attention")
    assert _build._lib_path("rmsnorm").parent == _build.BUILD_DIR
