#!/usr/bin/env python3
"""Split one RMSNorm call of the port into host time and device time.

    python3 scripts/rmsnorm_split.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so one run can time two trees side by side.  For each
shape, bf16 x and an f32 scale as the models pass them:

- host ms per call: ``time.perf_counter`` over 1,000 back-to-back calls
  with no synchronisation inside the loop (what the launch path costs the
  host);
- device ms per launch: 100 calls captured in one ``torch.cuda.CUDAGraph``,
  replays timed with CUDA events (the kernels launch on the current
  stream, so the capture holds them);
- the same two numbers for ``F.rms_norm`` (scale in x's dtype).

It also times the two ways to read the current stream's raw handle,
``torch.cuda.current_stream(dev).cuda_stream`` and
``torch._C._cuda_getCurrentRawStream(index)``, and checks that both give
the capture stream inside ``torch.cuda.graph``.  Needs an NVIDIA GPU; the
card's name and power limit are printed with the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ((8, 576), (8, 4096), (4096, 4096))
HOST_CALLS = 1000
GRAPH_CALLS = 100
REPLAYS = 20


def host_ms(fn, calls: int = HOST_CALLS) -> float:
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def device_ms(fn) -> float:
    """Device time per call: ``GRAPH_CALLS`` calls in one graph, replayed."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * GRAPH_CALLS)


def host_steps(rms_ops, x, s, calls: int = HOST_CALLS) -> dict:
    """Host µs per call of each step of the wrapper's CUDA path, each
    timed alone over ``calls`` calls (the launch step launches)."""
    import torch
    from repro_torch.kernels import _build
    dev = x.get_device()
    y = torch.empty_like(x)
    args = (x.data_ptr(), s.data_ptr(), y.data_ptr(), x.shape[0],
            x.shape[1], 1e-6, 0, 1, _build.stream(dev))
    steps = {
        "checks": lambda: (x.is_cuda, rms_ops._DTYPE_CODE.get(x.dtype),
                           s.shape != (x.shape[-1],), s.get_device(),
                           x.is_contiguous(), s.is_contiguous()),
        "empty_like": lambda: torch.empty_like(x),
        "new_empty": lambda: x.new_empty(x.shape),
        "empty": lambda: torch.empty(x.shape, dtype=x.dtype, device=x.device),
        "data_ptr x3": lambda: (x.data_ptr(), s.data_ptr(), y.data_ptr()),
        "stream": lambda: _build.stream(dev),
        "ctypes launch": lambda: rms_ops._LAUNCH(*args),
        "whole call": lambda: rms_ops.rmsnorm(x, s),
    }
    return {name: host_ms(fn, calls) * 1e3 for name, fn in steps.items()}


def stream_accessors() -> dict:
    import torch
    dev = torch.device("cuda", torch.cuda.current_device())
    idx = dev.index
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    torch.ones(1, device=dev).sum().item()    # the context exists
    torch.cuda.current_stream(dev)
    out = {}
    n = 10000
    t0 = time.perf_counter()
    for _ in range(n):
        torch.cuda.current_stream(dev).cuda_stream
    out["current_stream_us"] = (time.perf_counter() - t0) / n * 1e6
    if raw is not None:
        t0 = time.perf_counter()
        for _ in range(n):
            raw(idx)
        out["raw_stream_us"] = (time.perf_counter() - t0) / n * 1e6
    # inside a capture both must name the capture stream
    x = torch.ones(16, device=dev)
    g = torch.cuda.CUDAGraph()
    ctx = torch.cuda.graph(g)
    with ctx:
        want = ctx.capture_stream.cuda_stream
        out["current_stream_in_capture"] = \
            torch.cuda.current_stream(dev).cuda_stream == want
        out["raw_stream_in_capture"] = None if raw is None else \
            raw(idx) == want
        x.add_(1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_split: needs an NVIDIA GPU")
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[split] {smi}; repro_torch from {rms_ops.__file__}")
    res = {"smi": smi, "src": args.src, "streams": stream_accessors(),
           "shapes": {}}
    print(f"[split] stream accessors: {res['streams']}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for R, D in SHAPES:
        x = torch.randn((R, D), generator=gen, device="cuda").bfloat16()
        s = torch.randn((D,), generator=gen, device="cuda") + 1.0
        s_lib = s.bfloat16()
        rec = {
            "host_ms": host_ms(lambda: rms_ops.rmsnorm(x, s)),
            "device_ms": device_ms(lambda: rms_ops.rmsnorm(x, s)),
            "lib_host_ms": host_ms(lambda: F.rms_norm(x, (D,), s_lib,
                                                      eps=1e-6)),
            "lib_device_ms": device_ms(lambda: F.rms_norm(x, (D,), s_lib,
                                                          eps=1e-6)),
        }
        if hasattr(rms_ops, "_LAUNCH"):
            rec["host_steps_us"] = host_steps(rms_ops, x, s)
        res["shapes"][f"{R}x{D}"] = rec
        print(f"[split] rmsnorm ({R}, {D}) bf16: host {rec['host_ms']:.4f} "
              f"ms/call, device {rec['device_ms']:.5f} ms/launch; F.rms_norm "
              f"host {rec['lib_host_ms']:.4f}, device "
              f"{rec['lib_device_ms']:.5f}; host µs by step "
              f"{rec.get('host_steps_us')}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
