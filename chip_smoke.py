#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at the full width of smollm-135m (30
layers, d 576, 9/3 heads, head_dim 64, d_ff 1536, vocab 49152; random
weights from a seeded ``torch.Generator``) and checks it on the card:

1. device: name, count, and ``nvidia-smi`` name and power limit;
2. build: compiles every kernel under ``src/repro_torch/csrc`` with nvcc
   for sm_90a (one process per source, all at once);
3. kernels: each kernel against its plain PyTorch version at the shapes
   the main path gives it, bf16 (tolerance 2e-2) and f32 (2e-4), with
   kernel, plain and library times from CUDA events;
4. prefill: ``LM.prefill`` with ``use_kernels=True`` at B=4, S=1024
   against the plain path on the card (atol 0.25, rtol 0.1); the flash
   attention kernel must launch 30 times and the RMSNorm kernel 61;
5. serve: the ``ContinuousBatcher`` with 8 slots over 16 requests
   (prompts 16-256, 32-128 new tokens, greedy, seed 0); every request
   completes, two are re-decoded with ``decode_offline`` and must match
   token for token (a first divergence is accepted only where the offline
   top-2 logit margin is under 0.05), and the RMSNorm kernel launches at
   least 61 times per decode step.

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
#: where phases 3-5 run; only a rehearsal of the script changes it
DEVICE = "cuda"
PREFILL_B, PREFILL_S = 4, 1024
SLOTS, REQUESTS, SEED = 8, 16, 0
PROMPT_RANGE, GEN_RANGE = (16, 256), (32, 128)
MARGIN = 0.05


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
                dtype) -> float:
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    tol = TOL[dtype]
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {err} (tol {tol})")
    return err


def reset_counts() -> None:
    rms_ops.rmsnorm.launches = 0
    fa_ops.flash_attention.launches = 0


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
    return out


def phase_prefill(lm_k: LM, lm_p: LM, params) -> dict:
    cfg = lm_k.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    reset_counts()
    got = lm_k.prefill(params, batch)
    torch.cuda.synchronize()
    counts = {"flash_attention": fa_ops.flash_attention.launches,
              "rmsnorm": rms_ops.rmsnorm.launches}
    want = lm_p.prefill(params, batch)
    ms_k = time_ms(lambda: lm_k.prefill(params, batch), iters=5, warmup=1)
    ms_p = time_ms(lambda: lm_p.prefill(params, batch), iters=5, warmup=1)
    n_norm = 2 * cfg.n_layers + 1
    if counts != {"flash_attention": cfg.n_layers, "rmsnorm": n_norm}:
        raise AssertionError(f"prefill launches {counts}, expected "
                             f"{cfg.n_layers} flash and {n_norm} rmsnorm")
    if got.shape != (PREFILL_B, 1, cfg.vocab) or \
            not torch.isfinite(got.float()).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, atol=0.25, rtol=0.1):
        raise AssertionError(f"prefill kernel path vs plain: max abs err "
                             f"{err} (atol 0.25, rtol 0.1)")
    agree = (g.argmax(-1) == w.argmax(-1)).float().mean().item()
    print(f"[prefill] B={PREFILL_B} S={PREFILL_S}: logits vs plain max abs "
          f"err {err:.4f}, argmax agreement {agree:.2f}; launches {counts}; "
          f"{ms_k:.2f} ms with kernels, {ms_p:.2f} ms plain")
    return counts


def _first_divergence(streamed: list[int], offline: list[int]) -> int | None:
    for i, (a, b) in enumerate(zip(streamed, offline)):
        if a != b:
            return i
    if len(streamed) != len(offline):
        return min(len(streamed), len(offline))
    return None


def phase_serve(lm_k: LM, params, device: dict) -> dict:
    cfg = lm_k.cfg
    s_max = prefill_bucket(PROMPT_RANGE[1], 16) + GEN_RANGE[1]
    trace = make_trace(cfg, REQUESTS, seed=SEED,
                       prompt_len_range=PROMPT_RANGE, gen_range=GEN_RANGE)
    b = ContinuousBatcher(lm_k, params, slots=SLOTS, s_max=s_max, seed=SEED)
    for t in trace:
        b.submit(t["prompt"], t["max_new"], temperature=t["temperature"])
    reset_counts()
    rep = b.run()
    torch.cuda.synchronize()
    counts = {"flash_attention": fa_ops.flash_attention.launches,
              "rmsnorm": rms_ops.rmsnorm.launches}
    if len(rep.requests) != REQUESTS:
        raise AssertionError(f"{len(rep.requests)} of {REQUESTS} served")
    for r in rep.requests:
        if r.finish != "length" or len(r.out) != r.max_new:
            raise AssertionError(f"rid {r.rid}: finish {r.finish!r}, "
                                 f"{len(r.out)} of {r.max_new} tokens")
    n_norm = 2 * cfg.n_layers + 1
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
    print(f"[serve] {device['kind']} ({device['smi']}): {rep.generated} "
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

    cfg = get_config(ARCH)
    lm_k = LM(cfg, use_kernels=True, device=DEVICE)
    lm_p = LM(cfg, use_kernels=False, device=DEVICE)
    params, _ = lm_k.init(SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] {ARCH}: {n_params / 1e6:.1f}M params, "
          f"{cfg.n_layers} layers, d {cfg.d_model}")
    pre = phase_prefill(lm_k, lm_p, params)
    srv = phase_serve(lm_k, params, device)

    main_path = {k: pre[k] + srv[k] for k in pre}
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
