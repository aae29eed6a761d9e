"""``repro_torch.models.ssm`` and the selective-scan wrapper against the
reference.

The scans run in f32 on numpy inputs at the reference's 1e-4: the port's
doubling scan combines the same pairs as ``lax.associative_scan`` in
another order.  The Mamba block takes the jamba smoke config's mixer
params bridged in and is compared with the reference run op by op
(``jax.disable_jit``) at the bf16 tolerance; with kernels, the
reference's Pallas selective scan runs in interpret mode, as
``test_kernels.py`` runs it.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.ssd_scan import ops as jssd
from repro.models import ssm as jssm
from repro.models.lm import LM as JLM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as tssd
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.ref import (exp2_poly,
                                              ssd_scan_kernel_order,
                                              ssd_scan_ref)
from repro_torch.models import ssm as tssm
from torch_parity import both, f32, numpy_tree, tol

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)


def _noop(x, dims, site=None):
    return x


def _scan_inputs(B, S, Din, N, seed, dt_range=(0.01, 0.2)):
    """x, dt, A, B, C as (jax, torch) f32 pairs, at the reference's
    kernel-test distributions (dt uniform in ``dt_range``)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, S, Din)),
            rng.uniform(*dt_range, size=(B, S, Din)),
            -rng.uniform(0.5, 2.0, size=(Din, N)),
            rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))]
    return zip(*(both(a, "float32") for a in arrs))


# -- scans ---------------------------------------------------------------------


@pytest.mark.parametrize("B,S,Din,N", [(2, 33, 8, 4), (1, 64, 16, 8),
                                       (2, 1, 8, 4)])
def test_selective_scan_assoc_matches_reference(B, S, Din, N):
    j, t = _scan_inputs(B, S, Din, N, S)
    got = tssm.selective_scan_assoc(*t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, Din)
    np.testing.assert_allclose(f32(got), f32(jssm.selective_scan_assoc(*j)),
                               **SCAN_TOL)


@pytest.mark.parametrize("S,chunk", [(96, 16), (64, 32), (40, 16),
                                     (16, 16)])
def test_selective_scan_chunked_matches_reference(S, chunk):
    """(40, 16) and (16, 16) take the whole-sequence fallback."""
    j, t = _scan_inputs(2, S, 8, 4, S + chunk)
    got = tssm.selective_scan_chunked(*t, chunk=chunk)
    want = jssm.selective_scan_chunked(*j, chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), **SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_seq_matches_reference(with_h0):
    B, S, Din, N = 2, 24, 8, 4
    j, t = _scan_inputs(B, S, Din, N, 7)
    hj = ht = None
    if with_h0:
        hj, ht = both(np.random.default_rng(8).normal(size=(B, Din, N)),
                      "float32")
    yj, hj_out = jssm.selective_scan_seq(*j, hj)
    yt, ht_out = tssm.selective_scan_seq(*t, ht)
    np.testing.assert_allclose(f32(yt), f32(yj), **SCAN_TOL)
    np.testing.assert_allclose(f32(ht_out), f32(hj_out), **SCAN_TOL)


def test_doubling_scan_matches_steps():
    """The Hillis–Steele scan within the port agrees with its own step
    form, chunked or not."""
    _, t = _scan_inputs(2, 128, 8, 4, 9)
    want, _ = tssm.selective_scan_seq(*t)
    for got in (tssm.selective_scan_assoc(*t),
                tssm.selective_scan_chunked(*t, chunk=32)):
        np.testing.assert_allclose(f32(got), f32(want), **SCAN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,carry", [(10, False), (1, True), (5, True)])
def test_causal_conv_matches_reference(dtype, S, carry):
    rng = np.random.default_rng(S)
    B, k, Din = 2, 4, 6
    xj, xt = both(rng.normal(size=(B, S, Din)), dtype)
    wj, wt = both(rng.normal(size=(k, Din)) * 0.5, dtype)
    cj = ct = None
    if carry:
        cj, ct = both(rng.normal(size=(B, k - 1, Din)), dtype)
    got = tssm._causal_conv(xt, wt, ct)
    want = jssm._causal_conv(xj, wj, cj)
    assert got.dtype == xt.dtype and tuple(got.shape) == (B, S, Din)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


# -- the kernel's plain version ---------------------------------------------


@pytest.mark.parametrize("B,S,Din,N,chunk,dblk", [
    (2, 64, 16, 4, 16, 8),
    (1, 128, 32, 8, 32, 32),
    (2, 96, 24, 16, 48, 12),
])
def test_ssd_scan_matches_pallas(B, S, Din, N, chunk, dblk):
    """The reference's kernel-test shapes (``test_kernels.py``)."""
    j, t = _scan_inputs(B, S, Din, N, B * S + Din)
    want = jssd.ssd_scan(*j, chunk=chunk, d_block=dblk)
    got = tssd.ssd_scan(*t, chunk=chunk, d_block=dblk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), **SCAN_TOL)
    assert torch.equal(got, ssd_scan_ref(*t))


def test_exp2_poly_relative_error():
    """The kernel's software exponential within 3e-7 (about 2.5 f32
    ulps) of 2^z over [-126, 0]; every f32 in [-0.5, 0.5] measures at
    most 1.90e-7 (the minimax fit itself: 6.8e-8)."""
    rng = np.random.default_rng(0)
    z = np.concatenate([np.linspace(-126, 0, 1_000_001),
                        rng.uniform(-126, 0, 500_000),
                        rng.uniform(-0.5, 0.5, 500_000)]).astype(np.float32)
    got = exp2_poly(torch.from_numpy(z)).numpy().astype(np.float64)
    want = np.exp2(z.astype(np.float64))
    assert np.max(np.abs(got - want) / want) < 3e-7


def test_exp2_poly_never_wraps():
    """Below -126 the result lies in [0, 2^-126) and is 0 from -127 down:
    no inf, NaN or wrapped exponent; at 0 it is exactly 1."""
    z = torch.cat([torch.linspace(-1000, -126, 200_001),
                   torch.tensor([-126.5, -127.0, -127.5, -1e30,
                                 -float("inf")])])
    got = exp2_poly(z)
    assert torch.isfinite(got).all()
    assert (got >= 0).all() and (got <= 2.0 ** -126).all()
    assert (got[z <= -127] == 0).all()
    assert exp2_poly(torch.zeros(3)).tolist() == [1.0, 1.0, 1.0]


def test_kernel_order_mirrors_the_kernel_source():
    """The mirror's share of software exponentials and its polynomial
    are the ones ``csrc/ssd_scan.cu`` compiles."""
    src = (Path(ssd_ref.__file__).resolve().parents[2] / "csrc"
           / "ssd_scan.cu").read_text()
    share = re.search(r"constexpr int kPolyShare = (\d+);", src)
    assert share and int(share.group(1)) == ssd_ref.POLY_SHARE
    body = src[src.index("float exp2_poly(float z)"):]
    body = body[:body.index("\n}\n")]
    coeffs = [float(c) for c in re.findall(r"(\d\.\d+)f", body)]
    assert coeffs == list(ssd_ref.EXP2_COEFFS[::-1])


@pytest.mark.parametrize("dt_range", [(0.01, 0.2), (1e-4, 1e-3)])
@pytest.mark.parametrize("B,S,Din,N,chunk,dblk", [
    (2, 64, 16, 4, 16, 8),
    (1, 128, 32, 8, 32, 32),
    (2, 96, 24, 16, 48, 12),
])
def test_ssd_scan_kernel_order_matches_pallas(B, S, Din, N, chunk, dblk,
                                              dt_range):
    """The kernel's order and software exponential against the Pallas
    kernel at its test shapes; dt in [1e-4, 1e-3] puts exp(dt·A) within
    0.2% of 1, where an error in it is amplified most in h."""
    j, t = _scan_inputs(B, S, Din, N, B * S + Din, dt_range)
    want = jssd.ssd_scan(*j, chunk=chunk, d_block=dblk)
    got = ssd_scan_kernel_order(*t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, Din)
    np.testing.assert_allclose(f32(got), f32(want), **SCAN_TOL)


def test_ssd_scan_refuses_what_the_reference_asserts():
    _, t = _scan_inputs(1, 24, 16, 4, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssd.ssd_scan(*t, chunk=16)
    with pytest.raises(ValueError, match="d_block"):
        tssd.ssd_scan(*t, chunk=8, d_block=12)
    x = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        tssd.ssd_scan(x, x, torch.empty(16, 4, device="meta"),
                      torch.empty(1, 8, 4, device="meta"),
                      torch.empty(1, 8, 4, device="meta"), chunk=8)


# -- the Mamba block --------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """The jamba smoke config's first Mamba mixer, reference and port,
    with a non-zero ``a_log`` so A is not the init's -[2..N+1]."""
    cfg, jcfg = (get_config("jamba-v0.1-52b", smoke=True),
                 jget("jamba-v0.1-52b", smoke=True))
    jparams, _ = JLM(jcfg, remat="none").init(jax.random.PRNGKey(2))
    jp = dict(jparams["group0"]["b0"]["mix"])
    jp["a_log"] = jnp.asarray(np.random.default_rng(3).normal(
        size=jp["a_log"].shape) * 0.3, jnp.float32)
    return cfg, jcfg, jp, params_from_numpy(numpy_tree(jp), "cpu")


def test_mamba_param_paths(block):
    cfg, _, jp, tp = block
    Din = cfg.mamba.expand * cfg.d_model
    assert tssm.dt_rank(cfg) == 8
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert tp["a_log"].dtype == torch.float32 and tp["w_in"].shape == (
        cfg.d_model, 2 * Din)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S", [32, 16])
def test_mamba_block_full(block, use_kernels, S):
    """S = 32 runs the chunked scan (chunk 16), S = 16 its fallback."""
    cfg, jcfg, jp, tp = block
    xj, xt = both(np.random.default_rng(S).normal(size=(2, S, cfg.d_model)),
                  "bfloat16")
    with jax.disable_jit():
        want = jssm.mamba_block(xj, jp, jcfg, _noop, use_kernels=use_kernels)
    got = tssm.mamba_block(xt, tp, cfg, _noop, use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == xt.shape
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))


@pytest.mark.parametrize("S", [1, 3])
def test_mamba_block_step(block, S):
    cfg, jcfg, jp, tp = block
    B, Din, N = 2, cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    rng = np.random.default_rng(10 + S)
    hj, ht = both(rng.normal(size=(B, Din, N)), "float32")
    cj, ct = both(rng.normal(size=(B, cfg.mamba.d_conv - 1, Din)),
                  "bfloat16")
    xj, xt = both(rng.normal(size=(B, S, cfg.d_model)), "bfloat16")
    with jax.disable_jit():
        want, wstate, wcarry = jssm.mamba_block(
            xj, jp, jcfg, _noop, state=jssm.SSMState(hj), conv_carry=cj)
    got, gstate, gcarry = tssm.mamba_block(
        xt, tp, cfg, _noop, state=tssm.SSMState(ht), conv_carry=ct)
    np.testing.assert_allclose(f32(got), f32(want), **tol("bfloat16"))
    np.testing.assert_allclose(f32(gstate.h), f32(wstate.h), **SCAN_TOL)
    assert gcarry.dtype == torch.bfloat16
    assert np.array_equal(f32(gcarry), f32(wcarry))


def test_mamba_steps_reproduce_the_full_sequence(block):
    """Stepping one token at a time through the state and conv carry
    gives the full-sequence output."""
    cfg, _, _, tp = block
    B, S, Din = 2, 12, cfg.mamba.expand * cfg.d_model
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    full = tssm.mamba_block(x, tp, cfg, _noop)
    state = tssm.SSMState(torch.zeros(B, Din, cfg.mamba.d_state))
    carry, outs = None, []
    for t in range(S):
        out, state, carry = tssm.mamba_block(x[:, t:t + 1], tp, cfg, _noop,
                                             state=state, conv_carry=carry)
        outs.append(out)
    np.testing.assert_allclose(f32(torch.cat(outs, 1)), f32(full),
                               **tol("bfloat16"))
