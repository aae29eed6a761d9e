"""The port's benchmark: one run of one cell.

    python3 cardbench/run.py --workload smollm-135m.chat-cont32 \\
        --seed 7 --seconds 30 --trace 0

Reads the cell from ``BENCHMARK.json``, sets it up (the program's
compile, the weights from ``--seed``, every CUDA graph and kernel the
traffic uses), measures for ``--seconds``, and checks what the window
produced against the plain reference under ``cardbench/reference``.  The
last line of standard output is the result: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``trace_seconds`` of the window under ``torch.profiler``, begun
``trace_after_s`` into it).  The numbers compared are the last lines of
standard error, each beside its limit.

``--readings N`` (not a benchmark run) runs N seeds from ``--seed`` in
one process, each with its window, and prints on one line a seed the
numbers compared for the program, and on the first three seeds for the
control (the reference in fp8) too: the readings the limits are set
from.

It needs as many CUDA devices as the cell asks for, and refuses to
print a result with fewer, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, default=0)
    return ap.parse_args(argv)


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def one_run(args, files: dict, device, t_start: float,
            readings: bool = False) -> dict:
    """Set-up, window, the metrics and the check of one run."""
    import torch
    from cardbench import harness as H
    run = H.Run(name=args.workload, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device, files=files)
    run.arch = files["config"]["arch"]
    run.cfg = H.arch_config(run.arch)
    drv = H.driver(files["traffic"]["driver"])
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    if run.trace:
        H.count_kernel_work(run)
        tr = files["traffic"]
        run.tracer = H.Tracer(run, tr["trace_seconds"],
                              tr.get("trace_after_s", 0.0))
    drv.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    c0 = {k: v.tolist() for k, v in run.counters.items()}
    drv.window(run)
    run.rec["window_counters"] = {
        k: [b - a for a, b in zip(c0[k], v.tolist())]
        for k, v in run.counters.items()}
    run.traced = run.tracer.reduce() if run.tracer is not None else None
    device_rec = H.device_info(run, files["cell"]["chips"])
    e2e = drv.end_to_end(run)
    H.uncount_kernel_work(run)
    drv.release(run)
    checked = drv.check(run, readings=readings)
    return {"run": run, "setup_s": setup_s, "e2e": e2e,
            "device": device_rec, "checked": checked}


def main(argv=None, files: dict | None = None, device=None) -> int:
    args = parse(argv)
    from cardbench import harness as H
    H.env_dirs()
    import torch
    files = files or H.cell_files(args.workload)
    chips = files["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            say(f"cardbench: {args.workload} needs {chips} CUDA device(s); "
                f"{n} found")
            return 2
        device = torch.device("cuda", 0)
    if args.readings:
        return readings(args, files, device)

    out = one_run(args, files, device, T_START)
    run, checked = out["run"], out["checked"]
    checks = checked["checks"]
    correct = all(math.isfinite(v) and v <= lim for _n, v, lim in checks)
    if args.trace:
        metrics = {}
        for m in files["per_layer"]:
            v = H.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t = run.traced
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = {"device_ops": t["top_ops"], "idle_gaps": t["idle_gaps"]}
    else:
        vals = dict(out["e2e"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in files["end_to_end"]}
        breakdown = None
    bad = H.forbidden_modules()
    if bad:
        say(f"cardbench: modules of JAX or the JAX package loaded: {bad}")
        return 3
    line = H.result_line(correct, run.rec["attempted"], run.rec["failed"],
                         metrics, out["device"], checks, breakdown)
    print(line, flush=True)
    if "unit_s" in run.rec:
        say("window units (s): " + json.dumps(run.rec["unit_s"]))
    for name, v, lim in checks:
        say(f"check {name}: {v!r} (limit {lim!r})")
    return 0


#: the first seeds of ``--readings`` that also read the control (and the
#: faults and looks the driver reads beside it); the rest, the program
CONTROL_SEEDS = 3


def readings(args, files: dict, device) -> int:
    """The numbers compared for ``--readings`` seeds from ``--seed``, one
    line each: the program's, and on the first ``CONTROL_SEEDS`` the
    control's too."""
    import torch
    for i in range(args.readings):
        a = argparse.Namespace(**vars(args))
        a.seed = args.seed + i
        t0 = time.perf_counter()
        out = one_run(a, files, device, t0, readings=i < CONTROL_SEEDS)
        checked = out["checked"]
        rec = {"seed": a.seed, "readings": checked["readings"],
               "compared": out["checked"].get("compared"),
               "setup_s": out["setup_s"], "e2e": out["e2e"],
               "unit_s": out["run"].rec.get("unit_s"),
               "run_s": time.perf_counter() - t0,
               "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        print("[readings] " + json.dumps(rec), flush=True)
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
