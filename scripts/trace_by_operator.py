#!/usr/bin/env python3
"""Device time of a profiled prefill by the PyTorch operator that
launched it.

    python3 scripts/trace_by_operator.py TRACE

Reads a Chrome trace that ``chip_smoke.py`` phase 9 writes
(``build/traces/jamba-v0.1-52b_prefill.json``: one prefill
under ``torch.profiler``, inside a ``prefill_window`` annotation) and
sums the device operations in the window by the outermost PyTorch
operator (``cpu_op``) around the runtime call that launched each one,
matched by correlation id.  The hand-written kernels are launched by
``ctypes`` calls outside any operator and are summed apart.  Needs no
GPU: the trace holds the card's times.
"""
from __future__ import annotations

import bisect
import json
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_OP = "(no operator: hand-written kernels)"


def launching_op(events: list) -> dict:
    """Correlation id of each launch -> the outermost ``cpu_op`` around it
    on its thread."""
    tops: dict = {}
    for e in sorted((e for e in events if e.get("cat") == "cpu_op"),
                    key=lambda e: e["ts"]):
        lst = tops.setdefault(e["tid"], [])
        if not lst or e["ts"] >= lst[-1]["ts"] + lst[-1]["dur"]:
            lst.append(e)
    starts = {tid: [e["ts"] for e in lst] for tid, lst in tops.items()}
    out = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        lst = tops.get(e["tid"], [])
        i = bisect.bisect_right(starts.get(e["tid"], []), e["ts"]) - 1
        if i >= 0 and e["ts"] <= lst[i]["ts"] + lst[i]["dur"]:
            out[e["args"].get("correlation")] = lst[i]["name"]
    return out


def by_operator(events: list) -> dict:
    """Operator -> [device ms, device operations] inside the window."""
    win = [e for e in events if e.get("name") == "prefill_window"
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise SystemExit(f"trace_by_operator: {len(win)} prefill windows")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    launcher = launching_op(events)
    out: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and lo <= e["ts"] < hi:
            op = launcher.get(e["args"].get("correlation"), NO_OP)
            ms, n = out.get(op, (0.0, 0))
            out[op] = [ms + e["dur"] / 1e3, n + 1]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    with open(argv[1]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    for op, (ms, n) in by_operator(events).items():
        print(f"{ms:10.3f} ms {n:6d}  {op}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
