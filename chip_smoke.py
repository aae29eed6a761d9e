#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's prefill and serving paths at the full width of two
models, with random weights from a seeded ``torch.Generator``:
smollm-135m (30 layers, d 576, 9/3 heads, head_dim 64, d_ff 1536, vocab
49152) and xlstm-125m (12 layers: 10 mLSTM, 2 sLSTM; d 768, 4 heads,
mLSTM head dim 384, chunk 256, vocab 50304, untied head).  On the card:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: compiles every kernel under ``src/repro_torch/csrc`` with nvcc
   for sm_90a (one process per source, all at once);
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main paths give it, bf16 and f32, with kernel, plain and library
   times from CUDA events: RMSNorm and flash attention at 2e-2 (bf16) and
   2e-4 (f32); the mLSTM chunkwise kernel at B=4, S=1024, H=4, Dh=384,
   chunk 256 at 2e-3, the reference's tolerance for it (no single
   PyTorch call computes it, so it has no library time);
4. smollm prefill: ``LM.prefill`` with ``use_kernels=True`` at B=4,
   S=1024 against the plain path on the card (atol 0.25, rtol 0.1); the
   flash attention kernel must launch 30 times and the RMSNorm kernel 61;
5. smollm serve: the ``ContinuousBatcher`` with 8 slots over 16 requests
   (prompts 16-256, 32-128 new tokens, greedy, seed 0); every request
   completes, two are re-decoded with ``decode_offline`` and must match
   token for token (a first divergence is accepted only where the offline
   top-2 logit margin is under 0.05), and the RMSNorm kernel launches at
   least 61 times per decode step;
6. xlstm prefill: as 4, at B=4, S=1024; the mLSTM kernel must launch 10
   times and the RMSNorm kernel 13 (12 ``norm1`` and ``final_norm``);
7. xlstm serve: as 5, over 8 requests (prompts 16-128, 16-64 new
   tokens); the RMSNorm kernel launches at least 13 times per step.

Each path's launch counts are set to 0 just before it and read just
after; the kernels' ``launches`` are their sums over phases 4-7.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and the script
exits non-zero without printing that line; so does a machine without a
card, or a directory that holds this file and nothing else of the repo.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as ml_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.launch.scheduler import (ContinuousBatcher,  # noqa: E402
                                          decode_offline, prefill_bucket)
from repro_torch.launch.serve import make_trace  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

# NVIDIA H100 SXM data sheet (dense): HBM rate and peak rates by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
ELT = {torch.bfloat16: 2, torch.float32: 4}
DTYPES = (torch.bfloat16, torch.float32)

ARCH = "smollm-135m"
XARCH = "xlstm-125m"
#: where phases 3-7 run; only a rehearsal of the script changes it
DEVICE = "cuda"
PREFILL_B, PREFILL_S = 4, 1024
SLOTS, REQUESTS, SEED = 8, 16, 0
PROMPT_RANGE, GEN_RANGE = (16, 256), (32, 128)
#: xlstm serving traffic (phase 7)
X_REQUESTS, X_PROMPT_RANGE, X_GEN_RANGE = 8, (16, 128), (16, 64)
MARGIN = 0.05
#: the reference's tolerance for the mLSTM kernel (tests/test_kernels.py)
MLSTM_TOL = 2e-3


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after ``warmup`` calls (warm L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                dtype, tol: float | None = None) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    tol = TOL[dtype] if tol is None else tol
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {err} (tol {tol})")
    return err


COUNTED = {"rmsnorm": rms_ops.rmsnorm,
           "flash_attention": fa_ops.flash_attention,
           "mlstm_chunk": ml_ops.mlstm_chunk}


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


# -- phases --------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name} x{count}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} built with nvcc {' '.join(_build.NVCC_FLAGS)}"
          f" in {time.perf_counter() - t0:.1f} s")


def rmsnorm_case(R: int, D: int, dtype) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(R * 7 + D)
    x = torch.randn((R, D), generator=gen, device=DEVICE).to(dtype)
    s = torch.randn((D,), generator=gen, device=DEVICE) + 1.0
    err = check_close(f"rmsnorm R={R} D={D} {dtype}",
                      rms_ops.rmsnorm(x, s), rmsnorm_ref(x, s), dtype)
    s_lib = s.to(dtype)
    b, by = bound_ms(2 * R * D * ELT[dtype] + 4 * D, 4 * R * D,
                     torch.float32)
    rec = {"max_abs_err": err,
           "ms": time_ms(lambda: rms_ops.rmsnorm(x, s)),
           "plain_ms": time_ms(lambda: rmsnorm_ref(x, s)),
           "library_ms": time_ms(
               lambda: F.rms_norm(x, (D,), s_lib, eps=1e-6)),
           "bound_ms": b, "bound_by": by}
    print(f"[kernels] rmsnorm R={R} D={D} {str(dtype)[6:]}: err {err:.3g}, "
          f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"F.rms_norm {rec['library_ms']:.4f} ms, bound {b:.3g} ms ({by})")
    return rec


def mha_case(B: int, S: int, H: int, KVH: int, Dh: int, window, dtype
             ) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(B * S + H + Dh)
    q = torch.randn((B, S, H, Dh), generator=gen, device=DEVICE).to(dtype)
    k = torch.randn((B, S, KVH, Dh), generator=gen, device=DEVICE).to(dtype)
    v = torch.randn((B, S, KVH, Dh), generator=gen, device=DEVICE).to(dtype)
    qk, kk, vk = (t.contiguous() for t in fa_ops.to_kernel_layout(q, k, v))
    tag = f"mha B={B} S={S} H={H}/{KVH} Dh={Dh} window={window}"
    err = check_close(
        f"{tag} {dtype}",
        fa_ops.flash_attention(qk, kk, vk, causal=True, window=window),
        attention_ref(qk, kk, vk, causal=True, window=window), dtype)
    # the same mha through the model-layout wrapper
    check_close(f"{tag} {dtype} (mha)",
                fa_ops.mha(q, k, v, causal=True, window=window),
                fa_ops.from_kernel_layout(attention_ref(
                    qk, kk, vk, causal=True, window=window), B), dtype)
    pos = torch.arange(S, device=DEVICE)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    pairs = int(mask.sum())
    ops = 2 * (Dh + Dh) * pairs * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * ELT[dtype]
    b, by = bound_ms(nbytes, ops, dtype)
    kl, vl = kk[:, None], vk[:, None]          # (B·KVH, 1, S, Dh)

    def library():
        if window is None:
            return F.scaled_dot_product_attention(qk, kl, vl, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(qk, kl, vl, attn_mask=mask,
                                              enable_gqa=True)
    rec = {"max_abs_err": err,
           "ms": time_ms(lambda: fa_ops.flash_attention(
               qk, kk, vk, causal=True, window=window), iters=20),
           "plain_ms": time_ms(lambda: attention_ref(
               qk, kk, vk, causal=True, window=window), iters=10),
           "library_ms": time_ms(library, iters=20),
           "bound_ms": b, "bound_by": by}
    print(f"[kernels] {tag} {str(dtype)[6:]}: err {err:.3g}, kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
          f"{rec['library_ms']:.4f} ms, bound {b:.3g} ms ({by})")
    return rec


def mlstm_flops(B: int, S: int, H: int, Dh: int, L: int) -> float:
    """FLOPs of the chunkwise algorithm at chunk ``L``, counted once per
    head: causal ``q kᵀ`` and ``w v`` inside each chunk, the read of C
    and n by every query, and the rank-L update of C and n."""
    pairs = (S // L) * L * (L + 1) // 2 + (S % L) * (S % L + 1) // 2
    per_head = 2 * (2 * pairs * Dh + 2 * S * Dh * Dh + 2 * S * Dh)
    return float(B * H * per_head)


def mlstm_case(B: int, S: int, H: int, Dh: int, chunk: int, dtype) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(B * S + H + Dh)

    def rnd(*shape, shift=0.0):
        return (torch.randn(shape, generator=gen, device=DEVICE)
                + shift).to(dtype)
    q, k, v = (rnd(B, S, H, Dh) for _ in range(3))
    i_pre, f_pre = rnd(B, S, H), rnd(B, S, H, shift=2.0)
    tag = f"mlstm_chunk B={B} S={S} H={H} Dh={Dh} chunk={chunk}"

    def kernel():
        return ml_ops.mlstm_chunk(q, k, v, i_pre, f_pre, chunk=chunk)

    def plain():
        return ml_ops.mlstm_chunk_plain(q, k, v, i_pre, f_pre, chunk=chunk)
    err = check_close(f"{tag} {dtype}", kernel(), plain(), dtype,
                      tol=MLSTM_TOL)
    nbytes = (3 * q.numel() + 2 * i_pre.numel()) * ELT[dtype] \
        + 4 * q.numel()
    ops = mlstm_flops(B, S, H, Dh, ml_ops.KERNEL_CHUNK)
    b, by = bound_ms(nbytes, ops, dtype)
    peak = PEAK_OPS_PER_S[dtype]
    rec = {"max_abs_err": err, "ms": time_ms(kernel, iters=20),
           "plain_ms": time_ms(plain, iters=10), "library_ms": None,
           "library": "none: no single PyTorch call computes the mLSTM "
                      "chunkwise recurrence",
           "bound_ms": b, "bound_by": by,
           "bound_peak": f"{peak / 1e12:g} TFLOP/s ({str(dtype)[6:]}), "
                         f"{HBM_BYTES_PER_S / 1e12:g} TB/s"}
    print(f"[kernels] {tag} {str(dtype)[6:]}: err {err:.3g}, kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, no library "
          f"call, bound {b:.3g} ms ({by}; {ops / 1e9:.2f} GFLOP at the "
          f"{rec['bound_peak']} peaks)")
    return rec


def phase_kernels() -> dict:
    cfg = get_config(ARCH)
    D, H, KVH, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    out = {}
    for dtype in DTYPES:
        for R in (SLOTS, PREFILL_B * PREFILL_S):
            out[("rmsnorm", R, dtype)] = rmsnorm_case(R, D, dtype)
        for (S, h, kvh, window) in ((PREFILL_S, H, KVH, None),
                                    (PREFILL_S, H, KVH, 96),
                                    (PREFILL_S, KVH, KVH, None),
                                    (1000, H, KVH, None)):
            out[("mha", S, h, kvh, window, dtype)] = mha_case(
                PREFILL_B, S, h, kvh, Dh, window, dtype)
    xcfg = get_config(XARCH)
    xH = xcfg.n_heads
    xDh = xcfg.xlstm.proj_factor_mlstm * xcfg.d_model // xH
    for dtype in DTYPES:
        for R in (SLOTS, PREFILL_B * PREFILL_S):
            out[("rmsnorm", R, xcfg.d_model, dtype)] = rmsnorm_case(
                R, xcfg.d_model, dtype)
        out[("mlstm", dtype)] = mlstm_case(PREFILL_B, PREFILL_S, xH, xDh,
                                           xcfg.xlstm.chunk, dtype)
    return out


def expected_prefill_counts(cfg) -> dict:
    """Kernel launches of one prefill: a norm before every mixer, one
    before every FFN, the final norm; one flash-attention launch per
    attention layer and one mLSTM launch per mLSTM layer."""
    kinds = cfg.layer_kinds()
    return {"rmsnorm": cfg.n_layers + 1 + sum(f != "none" for _, f in kinds),
            "flash_attention": sum(m == "attn" for m, _ in kinds),
            "mlstm_chunk": sum(m == "mlstm" for m, _ in kinds)}


def phase_prefill(lm_k: LM, lm_p: LM, params, iters: int = 5) -> dict:
    cfg = lm_k.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    reset_counts()
    got = lm_k.prefill(params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    want = lm_p.prefill(params, batch)
    ms_k = time_ms(lambda: lm_k.prefill(params, batch), iters=iters,
                   warmup=1)
    ms_p = time_ms(lambda: lm_p.prefill(params, batch), iters=iters,
                   warmup=1)
    if counts != expected_prefill_counts(cfg):
        raise AssertionError(f"{cfg.name} prefill launches {counts}, "
                             f"expected {expected_prefill_counts(cfg)}")
    if got.shape != (PREFILL_B, 1, cfg.vocab) or \
            not torch.isfinite(got.float()).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, atol=0.25, rtol=0.1):
        raise AssertionError(f"prefill kernel path vs plain: max abs err "
                             f"{err} (atol 0.25, rtol 0.1)")
    agree = (g.argmax(-1) == w.argmax(-1)).float().mean().item()
    # the largest share of the allowed difference that any logit uses
    used = ((g - w).abs() / (0.25 + 0.1 * w.abs())).max().item()
    print(f"[prefill] {cfg.name} B={PREFILL_B} S={PREFILL_S}: logits vs "
          f"plain max abs err {err:.4f} (max |logit| "
          f"{w.abs().max().item():.3f}, {used:.2f} of the tolerance used), "
          f"argmax agreement {agree:.2f}; launches {counts}; "
          f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain")
    return counts


def _first_divergence(streamed: list[int], offline: list[int]) -> int | None:
    for i, (a, b) in enumerate(zip(streamed, offline)):
        if a != b:
            return i
    if len(streamed) != len(offline):
        return min(len(streamed), len(offline))
    return None


def phase_serve(lm_k: LM, params, device: dict, n_requests: int = REQUESTS,
                prompt_range=PROMPT_RANGE, gen_range=GEN_RANGE) -> dict:
    cfg = lm_k.cfg
    s_max = prefill_bucket(prompt_range[1], 16) + gen_range[1]
    trace = make_trace(cfg, n_requests, seed=SEED,
                       prompt_len_range=prompt_range, gen_range=gen_range)
    b = ContinuousBatcher(lm_k, params, slots=SLOTS, s_max=s_max, seed=SEED)
    for t in trace:
        b.submit(t["prompt"], t["max_new"], temperature=t["temperature"])
    reset_counts()
    rep = b.run()
    torch.cuda.synchronize()
    counts = read_counts()
    if len(rep.requests) != n_requests:
        raise AssertionError(f"{len(rep.requests)} of {n_requests} served")
    for r in rep.requests:
        if r.finish != "length" or len(r.out) != r.max_new:
            raise AssertionError(f"rid {r.rid}: finish {r.finish!r}, "
                                 f"{len(r.out)} of {r.max_new} tokens")
    n_norm = expected_prefill_counts(cfg)["rmsnorm"]
    if counts["rmsnorm"] < n_norm * rep.steps:
        raise AssertionError(f"rmsnorm launched {counts['rmsnorm']} times "
                             f"over {rep.steps} decode steps")
    for r in rep.requests[:2]:
        rows: list[np.ndarray] = []
        ref = decode_offline(lm_k, params, r, seed=SEED, s_max=s_max,
                             on_logits=rows.append)
        i = _first_divergence(r.out, ref)
        if i is None:
            print(f"[serve] rid {r.rid}: {len(ref)} streamed tokens equal "
                  "decode_offline")
            continue
        top2 = np.sort(rows[i])[-2:]
        margin = float(top2[1] - top2[0])
        print(f"[serve] rid {r.rid}: first divergence at token {i} of "
              f"{len(ref)}, offline top-2 logit margin {margin:.4f}")
        if margin >= MARGIN:
            raise AssertionError(f"rid {r.rid} diverges at token {i} with "
                                 f"margin {margin} >= {MARGIN}")
    d = rep.to_dict()
    print(f"[serve] {cfg.name} on {device['kind']} ({device['smi']}): "
          f"{rep.generated} "
          f"tokens / {len(rep.requests)} requests in {rep.wall_s:.2f} s, "
          f"{d['tok_per_s']:.1f} tok/s, p50 {d['latency_p50_s']:.3f} s, "
          f"p99 {d['latency_p99_s']:.3f} s, occupancy {rep.occupancy:.3f}, "
          f"{rep.steps} decode steps at "
          f"{rep.decode_s / max(rep.steps, 1) * 1e3:.2f} ms, prefill "
          f"{rep.prefill_s:.2f} s; launches {counts}")
    return counts


def main() -> int:
    device = phase_device()
    phase_build()
    cases = phase_kernels()

    cfg, lm_k, lm_p, params = build_model(ARCH)
    paths = [phase_prefill(lm_k, lm_p, params),
             phase_serve(lm_k, params, device)]
    del lm_k, lm_p, params
    xcfg, xlm_k, xlm_p, xparams = build_model(XARCH)
    paths += [phase_prefill(xlm_k, xlm_p, xparams, iters=3),
              phase_serve(xlm_k, xparams, device, X_REQUESTS,
                          X_PROMPT_RANGE, X_GEN_RANGE)]

    main_path = {k: sum(p[k] for p in paths) for k in COUNTED}
    xH = xcfg.n_heads
    xDh = xcfg.xlstm.proj_factor_mlstm * xcfg.d_model // xH
    kernels = [
        dict(name="rmsnorm", route="cuda",
             source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/kernel.py:26",
             launches=main_path["rmsnorm"],
             shape=f"x ({SLOTS}, {cfg.d_model}) bf16 (decode step)",
             **cases[("rmsnorm", SLOTS, torch.bfloat16)]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:76",
             launches=main_path["flash_attention"],
             shape=(f"B={PREFILL_B} S={PREFILL_S} H={cfg.n_heads}/"
                    f"{cfg.n_kv_heads} Dh={cfg.resolved_head_dim} causal "
                    "bf16 (prefill)"),
             **cases[("mha", PREFILL_S, cfg.n_heads, cfg.n_kv_heads, None,
                      torch.bfloat16)]),
        dict(name="mlstm_chunk", route="cuda",
             source="src/repro_torch/csrc/mlstm_chunk.cu",
             replaces="src/repro/kernels/mlstm_chunk/kernel.py:84",
             launches=main_path["mlstm_chunk"],
             shape=(f"B={PREFILL_B} S={PREFILL_S} H={xH} Dh={xDh} chunk "
                    f"{xcfg.xlstm.chunk} bf16 in, f32 out (xlstm prefill)"),
             **cases[("mlstm", torch.bfloat16)]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main "
                                 "path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}))
    return 0


def build_model(arch: str):
    cfg = get_config(arch)
    lm_k = LM(cfg, use_kernels=True, device=DEVICE)
    lm_p = LM(cfg, use_kernels=False, device=DEVICE)
    params, _ = lm_k.init(SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] {arch}: {n_params / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, d {cfg.d_model}")
    return cfg, lm_k, lm_p, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
