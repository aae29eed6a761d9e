#!/usr/bin/env python3
"""Two measurements of the port's mLSTM kernel on the card.

    python3 scripts/mlstm_probe.py

1. Where its time goes: the device time of each of its two kernels (the
   state pass and the output pass) at the xlstm-125m prefill shape (B=4,
   S=1024, H=4, Dh=384), bf16 and f32 inputs, from ``torch.profiler``
   over 10 calls.
2. How much room the xlstm-125m prefill check of ``chip_smoke.py``
   leaves: the same full-width prefill (B=4, S=1024, seed 0) with the
   mLSTM layers computed by the kernel and by the plain chunkwise version
   at chunks 64 and 256, each against the plain path
   (``_mlstm_parallel``), as the share of the check's tolerance (atol
   0.25, rtol 0.1) that the worst logit uses.

Needs an NVIDIA GPU; prints the card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as ml_ops  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402


def passes(dtype) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, Dh = 4, 1024, 4, 384
    q, k, v = (torch.randn(B, S, H, Dh, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    i = torch.randn(B, S, H, generator=gen, device="cuda").to(dtype)
    f = (torch.randn(B, S, H, generator=gen, device="cuda") + 2).to(dtype)
    for _ in range(3):
        ml_ops.mlstm_chunk(q, k, v, i, f, chunk=256)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ml_ops.mlstm_chunk(q, k, v, i, f, chunk=256)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("mlstm_state_kernel", "mlstm_out_kernel"):
            if name in ev.key:
                total = getattr(ev, "device_time_total", None)
                if total is None:
                    total = ev.cuda_time_total
                out[name] = total / ev.count / 1e3
    return out


def check_room() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-125m")
    lm_k = LM(cfg, use_kernels=True, device="cuda")
    lm_p = LM(cfg, use_kernels=False, device="cuda")
    params, _ = lm_k.init(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                         device="cuda")
    want = lm_p.prefill(params, {"tokens": toks}).float()

    def used() -> float:
        got = lm_k.prefill(params, {"tokens": toks}).float()
        return ((got - want).abs() / (0.25 + 0.1 * want.abs())).max().item()
    out = {"kernel": used()}
    kernel = ml_ops.mlstm_chunk
    try:
        for L in (64, 256):
            ml_ops.mlstm_chunk = (lambda q, k, v, i, f, chunk=128, L=L:
                                  ml_ops.mlstm_chunk_plain(q, k, v, i, f,
                                                           chunk=L))
            out[f"plain chunkwise {L}"] = used()
    finally:
        ml_ops.mlstm_chunk = kernel
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mlstm_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}")
    for dtype in (torch.bfloat16, torch.float32):
        print(f"[probe] mlstm_chunk {str(dtype)[6:]} device ms per pass: "
              f"{passes(dtype)}")
    print(f"[probe] xlstm-125m prefill vs the plain path, share of the "
          f"tolerance used: {check_room()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
