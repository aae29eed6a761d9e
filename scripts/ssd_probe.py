#!/usr/bin/env python3
"""What holds the selective-scan kernel (``csrc/ssd_scan.cu``) back.

    python3 scripts/ssd_probe.py

1. Registers and spills: builds the source with ``nvcc -Xptxas -v`` and
   prints what ptxas reports for each instantiation (N, x type, dt type).
2. The exponential's split between the MUFU and the FMA pipe: builds
   copies of the source with ``kPolyShare`` set to 0, 2 (the kernel's
   own) and 4 exponentials per 32 states on the FMA pipe, binds each to
   the wrapper's C entry in turn, checks it against ``ssd_scan_ref`` at
   jamba's prefill shape (B=4, S=1024, Din=8192, N=16, x bf16, dt f32)
   at 1e-4, and times them there in turns.
3. The kernel against its plain versions at the card tests' edge cases
   (``tests/test_torch_gpu.py``, ``test_ssd_scan_kernel_edges``): the max
   abs difference from ``ssd_scan_ref`` and from
   ``ssd_scan_kernel_order``, the readings behind those tests' limits.
4. The kernel as built at jamba's shape with x f32 (dt f32), and its
   scaling: times at B=4, N=16, x bf16, as S varies at Din=8192 and as
   Din varies at S=1024, beside its byte bound and the MUFU floor of its
   exponentials.  Time that scales with B·S·Din at a constant rate is a
   throughput floor; time that stays put as Din shrinks (fewer warps) is
   latency.

Times are CUDA events over back-to-back calls of the wrapper after
warm-up.  Needs an NVIDIA GPU; prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    POLY_SHARE, ssd_scan_kernel_order, ssd_scan_ref)

#: exponentials on the FMA pipe per 32 states; the first is the kernel's
SHARES = (POLY_SHARE, 0, 4)
#: (B, S, Din, N, dt range, -A range) of the card tests' edge cases
EDGES = ((2, 256, 1024, 16, (1e-4, 1e-3), (0.5, 2.0)),
         (2, 96, 256, 16, (0.5, 2.0), (1.0, 200.0)),
         (2, 256, 1024, 4, (0.01, 0.2), (0.5, 2.0)),
         (2, 256, 1024, 8, (0.01, 0.2), (0.5, 2.0)),
         (3, 50, 136, 16, (0.01, 0.2), (0.5, 2.0)),
         (1, 33, 8, 8, (1e-4, 1e-3), (0.5, 2.0)))
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM: 132 SMs, 16 MUFU results per SM per clock, 1.98 GHz boost
MUFU_PER_S = 132 * 16 * 1.98e9
OUT = _build.BUILD_DIR.parent / "ssd_probe"
SHARE_LINE = re.compile(r"constexpr int kPolyShare = (\d+);")


def build_shares() -> dict:
    """One nvcc per share, all at once, each on a copy of the source with
    ``kPolyShare`` replaced: share -> (library, ptxas log)."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    if int(SHARE_LINE.search(src).group(1)) != POLY_SHARE:
        raise AssertionError("ref.POLY_SHARE differs from the kernel's "
                             "kPolyShare")
    procs = {}
    for share in SHARES:
        cu = OUT / f"ssd_scan_share{share}.cu"
        cu.write_text(SHARE_LINE.sub(f"constexpr int kPolyShare = {share};",
                                     src))
        lib = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(cu)]
        procs[share] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for share, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc kPolyShare = {share} failed:\n{log}")
        out[share] = (lib, log)
    return out


def ptxas_report(log: str) -> list[str]:
    """ptxas's register and spill lines, one per kernel, demangled where
    a demangler is installed."""
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    rows, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if filt:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip()
            name = name[:name.find(">(") + 1] or name
        elif name and ("spill" in line or "Used" in line):
            rows.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return rows


def bind(lib: Path | None) -> None:
    """Point the wrapper's C entry at ``lib``, or back at the kernel as
    built (None); the signature is the wrapper's own."""
    if lib is None:
        ssd_ops._LAUNCH.fn = None
        return
    fn = ctypes.CDLL(str(lib)).ssd_scan_launch
    fn.argtypes = [_build._ARGTYPES[c] for c in ssd_ops._LAUNCH.signature]
    fn.restype = ctypes.c_int
    ssd_ops._LAUNCH.fn = fn


def inputs(B: int, S: int, Din: int, N: int = 16, dt_range=(0.01, 0.2),
           a_range=(0.5, 2.0), x_dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(B * S + Din + N)
    x = torch.randn((B, S, Din), generator=gen, device="cuda").to(x_dtype)
    lo, hi = dt_range
    dt = torch.rand((B, S, Din), generator=gen, device="cuda") * (hi - lo) + lo
    lo, hi = a_range
    A = -(torch.rand((Din, N), generator=gen, device="cuda") * (hi - lo) + lo)
    Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda")
              for _ in range(2))
    return x, dt, A, Bm, Cm


def scan(t) -> torch.Tensor:
    return ssd_ops.ssd_scan(*t, chunk=t[0].shape[1], d_block=t[0].shape[2])


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def floors(B: int, S: int, Din: int, N: int = 16, x_bytes: int = 2
           ) -> tuple[float, float]:
    """(byte bound, MUFU floor) in ms: x, dt f32 read, y f32 written;
    every exponential on the MUFU."""
    nbytes = B * S * Din * (x_bytes + 4 + 4) + Din * N * 4 + 2 * B * S * N * 4
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            B * S * Din * N / MUFU_PER_S * 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[probe] {smi}")
    libs = build_shares()
    for row in ptxas_report(libs[POLY_SHARE][1]):
        print(f"[probe] ptxas: {row}")

    B, S, Din = 4, 1024, 8192
    t = inputs(B, S, Din)
    want = ssd_scan_ref(*t)
    for share, (lib, _) in libs.items():
        bind(lib)
        y = scan(t)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        if not torch.allclose(y, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"kPolyShare = {share}: max abs err {err}")
        print(f"[probe] kPolyShare = {share}: max abs err {err:.3g}")
    del want, y
    times: dict = {s: [] for s in SHARES}
    for order in (SHARES, SHARES[::-1], SHARES):
        for share in order:
            bind(libs[share][0])
            times[share].append(time_ms(lambda: scan(t)))
    bind(None)
    bound, mufu = floors(B, S, Din)
    for share in SHARES:
        print(f"[probe] {share} of 16 exponentials on the FMA pipe: ms "
              f"{[round(ms, 4) for ms in times[share]]} (bytes "
              f"{bound:.4f} ms; MUFU for {16 - share} of 16 "
              f"{mufu * (16 - share) / 16:.4f} ms)")
    del t

    for B_, S_, Din_, N_, dt_range, a_range in EDGES:
        for x_dtype in (torch.bfloat16, torch.float32):
            t = inputs(B_, S_, Din_, N_, dt_range, a_range, x_dtype)
            y = scan(t)
            e_ref = (y - ssd_scan_ref(*t)).abs().max().item()
            e_ord = (y - ssd_scan_kernel_order(*t)).abs().max().item()
            print(f"[probe] edge B={B_} S={S_} Din={Din_} N={N_} dt "
                  f"{dt_range} -A {a_range} x {str(x_dtype)[6:]}: max abs "
                  f"diff {e_ref:.3g} from ssd_scan_ref, {e_ord:.3g} from "
                  f"ssd_scan_kernel_order (max |y| "
                  f"{y.abs().max().item():.3g})")

    t = inputs(B, S, Din, x_dtype=torch.float32)
    ms = time_ms(lambda: scan(t))
    bound, _ = floors(B, S, Din, x_bytes=4)
    print(f"[probe] B={B} S={S} Din={Din} x f32: {ms:.4f} ms; bytes "
          f"{bound:.4f} ms ({bound / ms:.2f} of it)")
    del t
    for S_, Din_ in ([(s, 8192) for s in (128, 256, 512, 1024, 2048)]
                     + [(1024, d) for d in (1024, 2048, 4096, 16384)]):
        t = inputs(B, S_, Din_)
        ms = time_ms(lambda: scan(t))
        bound, mufu = floors(B, S_, Din_)
        print(f"[probe] B={B} S={S_} Din={Din_} ({B * Din_} channels): "
              f"{ms:.4f} "
              f"ms, {B * S_ * Din_ / ms / 1e6:.1f} G channel-steps/s; bytes "
              f"{bound:.4f} ms ({bound / ms:.2f} of it), MUFU {mufu:.4f} ms")
        del t
    return 0


if __name__ == "__main__":
    sys.exit(main())
